"""Unified model API (port of ``repro.models.api``): every family of the
reference, dense, MoE and ``vlm`` (the transformer), ``ssm`` (xLSTM),
``hybrid`` (Zamba2) and ``audio`` (Whisper).

``build_model(cfg, device=None)`` returns a :class:`Model` whose members are
plain functions over a param dict, bound to one device.  ``device=None``
means the card; where no CUDA device exists that raises instead of falling
back to the CPU (pass ``device="cpu"`` to run the kernels' plain versions).

Every step function takes ``sharder=None``: with a
:class:`~repro_torch.models.sharding.Sharder` the params, cache and batch
are DTensors on its mesh (placed by ``param_rules``, ``cache_rules`` and
the batch rules of :func:`batch_rules`), the reference's constraints
redistribute the activations, and the kernels run on local shards.  Plain
tensors the step makes itself (positions, masks) count as replicated.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import torch

from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models import whisper as W
from repro_torch.models import xlstm as X
from repro_torch.models import zamba2 as Z
from repro_torch.models.config import ModelConfig, ShapeCell
from repro_torch.core.dtensor import is_dtensor


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
    forward: Callable        # (params, batch, sharder=None) -> logits
    prefill: Callable        # (params, batch, sharder=None) -> (logits, cache)
    decode_step: Callable    # (params, cache, batch, sharder=None) -> (logits, cache)
    init_cache: Callable     # (batch_size, max_len, window=None) -> cache
    #: the batch (slot) axis of the cache leaves: one int for every leaf,
    #: or a tree shaped like the cache with one int per leaf.  (L, B, S,
    #: Hkv, hd) KV caches use 1, xLSTM and Mamba2 states (G, M, B, ...) 2
    cache_batch_axis: int | dict
    param_rules: Callable    # () -> rules tree (Sharder format)
    cache_rules: Callable    # () -> rules tree for the cache
    input_specs: Callable    # (cell) -> batch tree of meta tensors


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (nested dicts and tuples of
    tensors) and the matching leaves of ``rest``, in the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


def on_mesh(fn):
    """``fn(..., sharder=None)`` that, given a sharder, runs under DTensor's
    implicit replication: the plain tensors the step builds itself
    (positions, masks, zero aux losses; the same on every rank) count as
    replicated where they meet a DTensor."""
    @functools.wraps(fn)
    def call(*args, sharder=None, **kw):
        if sharder is None:
            return fn(*args, **kw)
        from torch.distributed.tensor.experimental import implicit_replication

        with implicit_replication():
            return fn(*args, sharder=sharder, **kw)

    return call


def _generic_loss(forward_fn):
    """``Model.loss`` over ``forward_fn(params, batch, sharder=None) ->
    (logits, aux)``, as the reference's ``_generic_loss``: cross-entropy (a
    vision prefix carries labels -100) plus 0.01 x aux."""
    @on_mesh
    def loss(params, batch, sharder=None, aux_weight=0.01):
        logits, aux = forward_fn(params, batch, sharder=sharder)
        labels = batch["labels"]
        if logits.shape[1] != labels.shape[1]:  # vision prefix (VLM)
            pad = torch.full((labels.shape[0], logits.shape[1] - labels.shape[1]), -100,
                             dtype=labels.dtype, device=labels.device)
            labels = torch.cat([pad, labels], dim=1)
        ce = L.cross_entropy(logits, labels)
        if sharder is not None:   # reduce the vocab-parallel partial sums
            ce, aux = (sharder.constrain(t, []) if is_dtensor(t) else t for t in (ce, aux))
        return ce + aux_weight * aux, {"ce": ce, "aux": aux}

    return loss


def _no_aux(forward_fn):
    """(logits, aux = 0) of a family without an aux loss."""
    def fwd(params, batch, sharder=None):
        logits = forward_fn(params, batch, sharder=sharder)[0]
        return logits, torch.zeros((), dtype=torch.float32, device=logits.device)

    return fwd


def batch_rules(name: str):
    """The sharding rule of a batch leaf (the reference dry-run's
    ``shardings_for``): tokens and labels split their batch, patch
    embeddings and audio frames too; ``pos`` is replicated."""
    if name in ("tokens", "labels"):
        return ["batch", None]
    if name in ("patch_embeds", "frames"):
        return ["batch", None, None]
    return []


def token_specs(cfg: ModelConfig, cell: ShapeCell) -> dict:
    """The batch of one step of ``cell`` as ``meta`` tensors (the
    reference's ``ShapeDtypeStruct``s): tokens/labels int32, a decode
    step's one token and scalar ``pos``, a VLM's float32 patch embeddings
    and an audio model's frames."""
    B, S = cell.global_batch, cell.seq_len

    def meta(shape, dtype=torch.int32):
        return torch.empty(shape, dtype=dtype, device="meta")

    if cell.kind == "train":
        batch = {"tokens": meta((B, S)), "labels": meta((B, S))}
    elif cell.kind == "prefill":
        batch = {"tokens": meta((B, S))}
    else:   # decode: one new token, the cache covers seq_len
        batch = {"tokens": meta((B, 1)), "pos": meta(())}
    if cfg.vlm is not None and cell.kind != "decode":
        n_text = S - cfg.vlm.num_patches
        batch["tokens"] = meta((B, n_text))
        if "labels" in batch:
            batch["labels"] = meta((B, n_text))
        batch["patch_embeds"] = meta((B, cfg.vlm.num_patches, cfg.d_model), torch.float32)
    if cfg.encdec is not None and cell.kind != "decode":
        batch["frames"] = meta((B, cfg.encdec.encoder_frames, cfg.d_model), torch.float32)
    return batch


def _whisper_cache_rules():
    # kv=20 doesn't divide the 16-way model axis -> shard cache seq
    # (self: 32k); the cross cache's 1500 frames fall back to replication
    kv = {"k": [None, "batch", ["model"], None, None],
          "v": [None, "batch", ["model"], None, None]}
    return {"self": kv, "cross": kv}


def build_model(cfg: ModelConfig, device=None) -> Model:
    dev = resolve_device(device)
    if cfg.family not in ("dense", "moe", "vlm", "ssm", "hybrid", "audio"):
        raise ValueError(f"unknown family {cfg.family!r}")

    def generator(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    specs = functools.partial(token_specs, cfg)
    if cfg.family == "ssm":  # xLSTM
        fwd = lambda p, b, sharder=None, **kw: X.xlstm_forward(p, b, cfg, sharder=sharder, **kw)
        return Model(
            cfg=cfg,
            device=dev,
            init=lambda seed=0: X.xlstm_init(cfg, device=dev, generator=generator(seed)),
            loss=_generic_loss(_no_aux(fwd)),
            forward=on_mesh(lambda p, b, sharder=None: fwd(p, b, sharder)[0]),
            prefill=on_mesh(lambda p, b, sharder=None: fwd(p, b, sharder, return_cache=True)),
            decode_step=on_mesh(lambda p, c, b, sharder=None: X.xlstm_decode_step(
                p, c, b, cfg, sharder=sharder)),
            init_cache=lambda bs, ml, window=None: X.xlstm_init_cache(cfg, bs, ml, device=dev),
            cache_batch_axis=2,
            param_rules=lambda: X.xlstm_param_rules(cfg),
            cache_rules=X.xlstm_cache_rules,
            input_specs=specs,
        )
    if cfg.family == "hybrid":  # Zamba2
        fwd = lambda p, b, sharder=None, **kw: Z.zamba2_forward(p, b, cfg, sharder=sharder, **kw)
        return Model(
            cfg=cfg,
            device=dev,
            init=lambda seed=0: Z.zamba2_init(cfg, device=dev, generator=generator(seed)),
            loss=_generic_loss(_no_aux(fwd)),
            forward=on_mesh(lambda p, b, sharder=None: fwd(p, b, sharder)[0]),
            prefill=on_mesh(lambda p, b, sharder=None: fwd(p, b, sharder, return_cache=True)),
            decode_step=on_mesh(lambda p, c, b, sharder=None: Z.zamba2_decode_step(
                p, c, b, cfg, sharder=sharder)),
            init_cache=lambda bs, ml, window=None: Z.zamba2_init_cache(
                cfg, bs, ml, device=dev, window=window),
            # Mamba2 states (G, per, B, ...), KV caches (G, B, S, Hkv, hd)
            cache_batch_axis={"mamba": (2, 2), "attn_kv": {"k": 1, "v": 1}},
            param_rules=lambda: Z.zamba2_param_rules(cfg),
            cache_rules=Z.zamba2_cache_rules,
            input_specs=specs,
        )
    if cfg.family == "audio":  # Whisper: prefill returns {"self", "cross"}
        fwd = lambda p, b, sharder=None, **kw: W.whisper_forward(p, b, cfg, sharder=sharder,
                                                                 **kw)
        return Model(
            cfg=cfg,
            device=dev,
            init=lambda seed=0: W.whisper_init(cfg, device=dev, generator=generator(seed)),
            loss=_generic_loss(_no_aux(fwd)),
            forward=on_mesh(lambda p, b, sharder=None: fwd(p, b, sharder)[0]),
            prefill=on_mesh(lambda p, b, sharder=None: fwd(p, b, sharder, return_cache=True)),
            decode_step=on_mesh(lambda p, c, b, sharder=None: W.whisper_decode_step(
                p, c, b, cfg, sharder=sharder)),
            init_cache=lambda bs, ml, window=None: W.whisper_init_cache(cfg, bs, ml, device=dev),
            cache_batch_axis=1,
            param_rules=lambda: W.whisper_param_rules(cfg),
            cache_rules=_whisper_cache_rules,
            input_specs=specs,
        )
    # dense, moe, vlm: the reference's decode_step passes no window; a
    # windowed dense decode is lm_decode_step(window=) over init_cache(window=)
    fwd = lambda p, b, sharder=None, **kw: T.lm_forward(p, b, cfg, sharder=sharder, **kw)
    return Model(
        cfg=cfg,
        device=dev,
        init=lambda seed=0: T.lm_init(cfg, device=dev, generator=generator(seed)),
        loss=_generic_loss(lambda p, b, sharder=None: fwd(p, b, sharder)[::2]),  # (logits, aux)
        forward=on_mesh(lambda p, b, sharder=None: fwd(p, b, sharder)[0]),
        prefill=on_mesh(lambda p, b, sharder=None: fwd(p, b, sharder, return_cache=True)[:2]),
        decode_step=on_mesh(lambda p, c, b, sharder=None: T.lm_decode_step(
            p, c, b, cfg, sharder=sharder)),
        init_cache=lambda bs, ml, window=None: T.lm_init_cache(cfg, bs, ml, device=dev,
                                                                window=window),
        cache_batch_axis=1,
        param_rules=lambda: T.lm_param_rules(cfg),
        cache_rules=lambda: T.lm_cache_rules(cfg),
        input_specs=specs,
    )
