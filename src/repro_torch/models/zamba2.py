"""Zamba2 (port of ``repro.models.zamba2``): a Mamba2 backbone with one
weight-shared attention block.

``cfg.num_layers`` Mamba2 blocks; after every ``cfg.ssm.attn_every`` of them
ONE shared transformer block (full attention + SwiGLU MLP, the same weights
at every application) refines the stream, each application with a KV cache
of its own.

Differences from the reference, all forced by PyTorch or chosen for memory:

* params and states keep the reference's stacked layout, Mamba2 leaves
  ``(G, per, ...)`` and KV caches ``(G, B, S, Hkv, hd)``, consumed by Python
  loops (the reference scans them);
* the decode step updates the cache in place: :func:`ssd_step` rewrites the
  float32 h it is given, the attention writes its one new position, and
  the conv states are copied into their lanes.

For the long-context cells the shared block runs sliding-window attention
(``window``, default ``cfg.ssm.attn_window``) over a ring cache of
min(max_len, window) slots, as in the reference.  The sharding hooks are not
ported yet.
"""

from __future__ import annotations

import math

import torch

from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.models.mamba2 import mamba2_block_apply, mamba2_block_init, mamba2_state_init
from repro_torch.models.xlstm import _at, _stack_states


def _group_counts(cfg: ModelConfig):
    per = cfg.ssm.attn_every
    if cfg.num_layers % per:
        raise ValueError(f"num_layers {cfg.num_layers} is no multiple of attn_every {per}")
    return cfg.num_layers // per, per


def zamba2_init(cfg: ModelConfig, *, device, generator: torch.Generator):
    """Random parameters with the reference's shapes and scales, drawn from
    ``generator`` (a generator on ``device``) into ``param_dtype`` tensors
    on the device (``A_log``, ``dt_bias`` and ``D`` float32)."""
    G, per = _group_counts(cfg)
    dt = T.torch_dtype(cfg.param_dtype)
    d, V = cfg.d_model, cfg.vocab_size

    def normal(shape, scale):
        return torch.empty(shape, dtype=dt, device=device).normal_(generator=generator).mul_(scale)

    mamba = mamba2_block_init(cfg, (G, per), device=device, generator=generator)
    shared = T.layers_init(cfg, 1, device=device, generator=generator)   # ONE copy
    return {
        "embed": {"table": normal((V, d), 0.02)},
        "mamba": mamba,
        "shared_attn": T._layer(shared, 0),
        "final_norm": {"scale": torch.ones(d, dtype=dt, device=device)},
        "head": {"w": normal((d, V), 1.0 / math.sqrt(d))},
    }


def zamba2_forward(p, batch, cfg: ModelConfig, *, return_cache=False, window=None):
    """Train/prefill forward, the shared block windowed by ``window``
    (default ``cfg.ssm.attn_window``).  Returns (logits, cache): the cache is
    ``{"mamba": (h, conv), "attn_kv": {"k", "v"}}`` with Mamba2 leaves
    ``(G, per, B, ...)`` and KV leaves ``(G, B, S, Hkv, hd)`` when
    ``return_cache``, else None."""
    G, per = _group_counts(cfg)
    win = window if window is not None else cfg.ssm.attn_window
    dt = T.torch_dtype(cfg.dtype)
    x = L.embed(p["embed"], batch["tokens"], dt)
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    mst, kvs = [], []
    for g in range(G):
        mst.append([])
        for j in range(per):
            x, st = T.remat(mamba2_block_apply, cfg, x)(_at(p["mamba"], g, j), x, cfg)
            mst[-1].append(st)
        x, kv, _ = T.layer_apply(p["shared_attn"], x, cfg, positions=positions, window=win)
        kvs.append(kv)
    x = L.rmsnorm(p["final_norm"], x, cfg.norm_eps)
    logits = L.unembed(p["head"], x, dt)
    if not return_cache:
        return logits, None
    return logits, {"mamba": _stack_states(mst),
                    "attn_kv": {n: torch.stack([kv[n] for kv in kvs]) for n in ("k", "v")}}


def zamba2_init_cache(cfg: ModelConfig, batch: int, max_len: int, *, device, window=None):
    """Zero Mamba2 states ``(G, per, B, ...)`` and a KV cache ``(G, B, S,
    Hkv, hd)`` per shared-block application: S = max_len, or a ring of S =
    min(max_len, window) slots (``window`` default ``cfg.ssm.attn_window``)."""
    G, per = _group_counts(cfg)
    win = window if window is not None else cfg.ssm.attn_window
    S = min(max_len, win) if win is not None else max_len
    shape = (G, batch, S, cfg.num_kv_heads, cfg.resolved_head_dim)
    dt = T.torch_dtype(cfg.dtype)
    mst = tuple(a.expand(G, per, *a.shape).clone()
                for a in mamba2_state_init(cfg, batch, device=device))
    return {"mamba": mst,
            "attn_kv": {n: torch.zeros(shape, dtype=dt, device=device) for n in ("k", "v")}}


def zamba2_decode_step(p, cache, batch, cfg: ModelConfig, *, window=None):
    """One decode step: ``batch = {tokens: (B, 1), pos: scalar or (B,)}``,
    the shared block windowed by ``window`` (default
    ``cfg.ssm.attn_window``) over a ring cache.  Every leaf of ``cache`` is
    updated in place.  Returns (logits (B, 1, V), cache)."""
    G, per = _group_counts(cfg)
    win = window if window is not None else cfg.ssm.attn_window
    dt = T.torch_dtype(cfg.dtype)
    x = L.embed(p["embed"], batch["tokens"], dt)
    pos = torch.as_tensor(batch["pos"], device=x.device)
    if pos.ndim == 0:
        positions = pos.reshape(1).to(torch.int32)      # (t=1,) synchronous
    else:
        positions = pos[:, None].to(torch.int32)        # (B, t=1) per-slot
    for g in range(G):
        for j in range(per):
            lanes = tuple(leaf[g, j] for leaf in cache["mamba"])
            x, new = mamba2_block_apply(_at(p["mamba"], g, j), x, cfg, state=lanes, decode=True)
            for dst, src in zip(lanes, new):
                if src is not dst:
                    dst.copy_(src)
        x, _, _ = T.layer_apply(p["shared_attn"], x, cfg, positions=positions,
                             cache=T._layer(cache["attn_kv"], g), cache_pos=pos, window=win)
    x = L.rmsnorm(p["final_norm"], x, cfg.norm_eps)
    return L.unembed(p["head"], x, dt), cache
