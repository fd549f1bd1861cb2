"""Unified model API (port of ``repro.models.api``): every family of the
reference, dense, MoE and ``vlm`` (the transformer), ``ssm`` (xLSTM),
``hybrid`` (Zamba2) and ``audio`` (Whisper).

``build_model(cfg, device=None)`` returns a :class:`Model` whose members are
plain functions over a param dict, bound to one device.  ``device=None``
means the card; where no CUDA device exists that raises instead of falling
back to the CPU (pass ``device="cpu"`` to run the kernels' plain versions).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models import whisper as W
from repro_torch.models import xlstm as X
from repro_torch.models import zamba2 as Z
from repro_torch.models.config import ModelConfig


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``.  A CUDA device that is not available raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU"
        )
    return dev


@dataclasses.dataclass
class Model:
    cfg: ModelConfig
    device: torch.device
    init: Callable           # (seed=0) -> params on device
    loss: Callable           # (params, batch, sharder=None) -> (loss, metrics)
    forward: Callable        # (params, batch) -> logits
    prefill: Callable        # (params, batch) -> (logits, cache)
    decode_step: Callable    # (params, cache, batch) -> (logits, cache), cache in place
    init_cache: Callable     # (batch_size, max_len, window=None) -> cache
    #: the batch (slot) axis of the cache leaves: one int for every leaf,
    #: or a tree shaped like the cache with one int per leaf.  (L, B, S,
    #: Hkv, hd) KV caches use 1, xLSTM and Mamba2 states (G, M, B, ...) 2
    cache_batch_axis: int | dict


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (nested dicts and tuples of
    tensors) and the matching leaves of ``rest``, in the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


def _generic_loss(forward_fn):
    """``Model.loss`` over ``forward_fn(params, batch) -> (logits, aux)``, as
    the reference's ``_generic_loss``: cross-entropy (a vision prefix
    carries labels -100) plus 0.01 x aux.  A sharder waits for ROADMAP
    Queue 1 item 13."""
    def loss(params, batch, sharder=None, aux_weight=0.01):
        if sharder is not None:
            raise NotImplementedError("sharded loss waits for ROADMAP Queue 1 item 13")
        logits, aux = forward_fn(params, batch)
        labels = batch["labels"]
        if logits.shape[1] != labels.shape[1]:  # vision prefix (VLM)
            pad = torch.full((labels.shape[0], logits.shape[1] - labels.shape[1]), -100,
                             dtype=labels.dtype, device=labels.device)
            labels = torch.cat([pad, labels], dim=1)
        ce = L.cross_entropy(logits, labels)
        return ce + aux_weight * aux, {"ce": ce, "aux": aux}

    return loss


def _no_aux(forward_fn):
    """(logits, aux = 0) of a family without an aux loss."""
    def fwd(params, batch):
        logits = forward_fn(params, batch)[0]
        return logits, torch.zeros((), dtype=torch.float32, device=logits.device)

    return fwd


def build_model(cfg: ModelConfig, device=None) -> Model:
    dev = resolve_device(device)
    if cfg.family not in ("dense", "moe", "vlm", "ssm", "hybrid", "audio"):
        raise ValueError(f"unknown family {cfg.family!r}")

    def generator(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    if cfg.family == "ssm":  # xLSTM
        return Model(
            cfg=cfg,
            device=dev,
            init=lambda seed=0: X.xlstm_init(cfg, device=dev, generator=generator(seed)),
            loss=_generic_loss(_no_aux(lambda p, b: X.xlstm_forward(p, b, cfg))),
            forward=lambda p, b: X.xlstm_forward(p, b, cfg)[0],
            prefill=lambda p, b: X.xlstm_forward(p, b, cfg, return_cache=True),
            decode_step=lambda p, c, b: X.xlstm_decode_step(p, c, b, cfg),
            init_cache=lambda bs, ml, window=None: X.xlstm_init_cache(cfg, bs, ml, device=dev),
            cache_batch_axis=2,
        )
    if cfg.family == "hybrid":  # Zamba2
        return Model(
            cfg=cfg,
            device=dev,
            init=lambda seed=0: Z.zamba2_init(cfg, device=dev, generator=generator(seed)),
            loss=_generic_loss(_no_aux(lambda p, b: Z.zamba2_forward(p, b, cfg))),
            forward=lambda p, b: Z.zamba2_forward(p, b, cfg)[0],
            prefill=lambda p, b: Z.zamba2_forward(p, b, cfg, return_cache=True),
            decode_step=lambda p, c, b: Z.zamba2_decode_step(p, c, b, cfg),
            init_cache=lambda bs, ml, window=None: Z.zamba2_init_cache(
                cfg, bs, ml, device=dev, window=window),
            # Mamba2 states (G, per, B, ...), KV caches (G, B, S, Hkv, hd)
            cache_batch_axis={"mamba": (2, 2), "attn_kv": {"k": 1, "v": 1}},
        )
    if cfg.family == "audio":  # Whisper: prefill returns {"self", "cross"}
        return Model(
            cfg=cfg,
            device=dev,
            init=lambda seed=0: W.whisper_init(cfg, device=dev, generator=generator(seed)),
            loss=_generic_loss(_no_aux(lambda p, b: W.whisper_forward(p, b, cfg))),
            forward=lambda p, b: W.whisper_forward(p, b, cfg)[0],
            prefill=lambda p, b: W.whisper_forward(p, b, cfg, return_cache=True),
            decode_step=lambda p, c, b: W.whisper_decode_step(p, c, b, cfg),
            init_cache=lambda bs, ml, window=None: W.whisper_init_cache(cfg, bs, ml, device=dev),
            cache_batch_axis=1,
        )
    # dense, moe, vlm: the reference's decode_step passes no window; a
    # windowed dense decode is lm_decode_step(window=) over init_cache(window=)
    return Model(
        cfg=cfg,
        device=dev,
        init=lambda seed=0: T.lm_init(cfg, device=dev, generator=generator(seed)),
        loss=_generic_loss(lambda p, b: T.lm_forward(p, b, cfg)[::2]),   # (logits, aux)
        forward=lambda p, b: T.lm_forward(p, b, cfg)[0],
        prefill=lambda p, b: T.lm_forward(p, b, cfg, return_cache=True)[:2],
        decode_step=lambda p, c, b: T.lm_decode_step(p, c, b, cfg),
        init_cache=lambda bs, ml, window=None: T.lm_init_cache(cfg, bs, ml, device=dev,
                                                                window=window),
        cache_batch_axis=1,
    )
