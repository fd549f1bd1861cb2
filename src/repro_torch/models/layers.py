"""Shared neural building blocks (port of ``repro.models.layers``).

Conventions, as in the reference:
* params are plain dicts of tensors in ``param_dtype``, with the reference's
  layouts: dense weights ``(in, out)``, ``wq/wk/wv (d, heads, hd)``,
  ``wo (heads, hd, d)``, KV caches ``(B, S, Hkv, hd)``;
* ``apply`` functions cast to the compute dtype at use sites and keep
  normalisation/softmax statistics in float32.

Attention goes through the kernel wrappers of :mod:`repro_torch.kernels.ops`:
flash attention for prefill/full/cross attention (with the sliding window
of the long-context cells), decode attention for one new token per sequence
over a linear or ring cache, an int8 cache or a static cross-attention
cache.  Those launch the hand-written CUDA
kernels for CUDA tensors and run their plain versions for CPU tensors.  Both
compute the softmax probabilities in float32 (the reference model rounds
them to the compute dtype before the PV product), so in bfloat16 the port
and the reference differ by rounding; in float32 they agree.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.kernels.ref import NEG_INF


def _cast(x, dtype):
    return x if x.dtype == dtype else x.to(dtype)


def dense(p, x, dtype):
    y = x @ _cast(p["w"], dtype)
    if "b" in p:
        y = y + _cast(p["b"], dtype)
    return y


# --------------------------------------------------------------------------
# norms
# --------------------------------------------------------------------------


def rmsnorm(p, x, eps=1e-5):
    dt = x.dtype
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p["scale"].float()).to(dt)


def layernorm(p, x, eps=1e-5):
    dt = x.dtype
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"].float() + p["bias"].float()).to(dt)


# --------------------------------------------------------------------------
# rotary position embedding
# --------------------------------------------------------------------------


def rope_freqs(head_dim, theta):
    # numpy float32, exactly as the reference computes them
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float32) / head_dim))


@functools.lru_cache(maxsize=16)
def _rope_freqs_on(head_dim, theta, device):
    return torch.from_numpy(rope_freqs(head_dim, theta)).to(device)


def apply_rope(x, positions, theta):
    """x: (..., seq, heads, head_dim); positions: (..., seq) int."""
    freqs = _rope_freqs_on(x.shape[-1], theta, x.device)        # (hd/2,)
    angles = positions[..., :, None].float() * freqs            # (..., seq, hd/2)
    cos = torch.cos(angles)[..., :, None, :]                    # broadcast over heads
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# GQA attention
# --------------------------------------------------------------------------


def _project(p, x, name, dtype):
    """x (b, t, d) @ p[w<name>] (d, heads, hd) (+ p[b<name>]) -> (b, t, heads, hd)."""
    b, t, d = x.shape
    w = p["w" + name]
    y = (x @ _cast(w, dtype).reshape(d, -1)).view(b, t, *w.shape[1:])
    return y + _cast(p["b" + name], dtype) if "b" + name in p else y


def _project_qkv(p, x, dtype, x_kv=None):
    xkv = x if x_kv is None else x_kv
    return _project(p, x, "q", dtype), _project(p, xkv, "k", dtype), _project(p, xkv, "v", dtype)


def gqa_scores_softmax_value(q, k, v, mask, *, q_per_kv):
    """Grouped attention without materialising repeated KV (the reference
    model's einsum path, kept as a plain cross-check of the kernels).

    q: (b, t, h, hd) with h = hk * q_per_kv; k, v: (b, s, hk, hd);
    mask: broadcastable to (b, 1, 1, t, s) boolean (True = attend).
    """
    b, t, h, hd = q.shape
    hk = k.shape[2]
    qg = q.reshape(b, t, hk, q_per_kv, hd)
    scores = torch.einsum("bthgk,bshk->bhgts", qg, k) / math.sqrt(hd)
    scores = torch.where(mask, scores.float(), NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bhgts,bshk->bthgk", probs, v)
    return out.reshape(b, t, h, hd)


def _quantize_kv(x):
    """Per-(b, t, head) symmetric int8: x (B, t, hk, hd) -> (int8 same
    shape, float32 scale (B, t, hk, 1)); ``torch.round`` rounds half to even
    as ``jnp.round`` does, so the int8 values equal the reference's."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1, keepdim=True).clamp(min=1e-8) / 127.0
    return torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8), scale


def causal_mask(t, s, q_offset=0, window=None, device=None):
    """(1,1,1,t,s) boolean; query position i = q_offset + i attends to
    key positions j <= i (and j > i - window when windowed)."""
    qi = torch.arange(t, device=device)[:, None] + q_offset
    kj = torch.arange(s, device=device)[None, :]
    m = kj <= qi
    if window is not None:
        m = m & (kj > qi - window)
    return m[None, None, None]


def _cache_write(caches, news, cache_pos, *, ring=False):
    """Write the new token's leaves ``news`` (each (B, 1, ...)) into the
    cache leaves ``caches`` (each (B, S, ...)) in place and return the
    per-sequence attended length, mirroring the reference exactly:

    * a linear cache, per-slot ``cache_pos`` (B,): a scatter at
      ``[b, pos[b]]``; a lane with ``pos >= S`` writes nothing (XLA drops
      out-of-bounds scatter updates);
    * a linear cache, scalar ``cache_pos``: ``dynamic_update_slice``, whose
      start clamps to ``[0, S - 1]``;
    * a ring (``ring``, the windowed cache of S = min(max_len, window)
      slots): every lane writes at ``pos % S``.

    The reference then masks key ``j <= pos`` (linear), which is the
    kernel's ``j < length`` with ``length = min(pos + 1, S)``.  For the
    ring it keeps slot j iff the newest position it holds, ``pos - ((pos -
    j) mod S)``, is >= 0 and > pos - window (``repro/models/layers.py:
    326-330``).  Since window >= S the second always holds, and the first
    holds iff j < min(pos + 1, S): the same length.  Attention does not
    depend on the order of the keys (RoPE is already in each key), so the
    ring needs only the wrapped write.
    """
    B, S = caches[0].shape[0], caches[0].shape[1]
    dev = caches[0].device
    pos = cache_pos.to(device=dev, dtype=torch.int64)
    if pos.ndim == 1:
        bidx = torch.arange(B, device=dev)
        if ring:
            idx = pos % S
            for c, n in zip(caches, news):
                c[bidx, idx] = n[:, 0]
        else:
            idx = pos.clamp(max=S - 1)
            keep = pos < S
            for c, n in zip(caches, news):
                mask = keep.view(B, *[1] * (c.ndim - 2))
                c[bidx, idx] = torch.where(mask, n[:, 0], c[bidx, idx])
    else:
        start = (pos % S if ring else pos.clamp(0, S - 1)).reshape(1)
        for c, n in zip(caches, news):
            c.index_copy_(1, start, n)
        pos = pos.expand(B)
    return (pos + 1).clamp(max=S).to(torch.int32)


def attention_apply(
    p,
    x,
    *,
    dtype,
    rope_theta: float | None,
    positions,
    causal: bool = True,
    window: int | None = None,
    cache: dict | None = None,
    cache_pos=None,
    x_kv=None,
    static_cache: bool = False,
):
    """Full/causal/cross attention with an optional KV cache.  Head counts
    come from the weights: ``wq (d, H, hd)``, ``wk/wv (d, Hkv, hd)``.

    Modes, as the reference's:
    * prefill/full:  cache=None -> one flash-attention call over x (keys and
                     values from ``x_kv`` for cross attention, which takes
                     no RoPE); a causal ``window`` masks keys j <= i -
                     window.  Returns the new cache ``{k, v}`` built from
                     x (any length: the reference's q-chunked path above
                     ``attn_chunk`` computes the same math);
    * static cache:  ``static_cache`` with cache={'k','v'} -> the one new
                     token attends every slot of a read-only cache (the
                     encoder's K/V in cross-attention decode); the cache is
                     returned unchanged;
    * int8 cache:    cache={'k','v','k_scale','v_scale'} (int8 and float32
                     (B, S, Hkv, 1)) -> the new token is quantized and
                     written at ``cache_pos`` in place (a linear write, the
                     window ignored, as in the reference), then attends
                     keys j <= pos, dequantized as the reference does;
    * decode:        cache={'k','v'} (B, S, hk, hd); the one new token is
                     written at ``cache_pos`` — (B,) per slot or a scalar —
                     **in place**, at ``pos % S`` when windowed (a ring of
                     S = min(max_len, window) slots), then attends over the
                     cache through the decode kernel.  The returned cache
                     is the same dict.
    """
    b, t, d = x.shape
    if cache is not None and t != 1:
        raise NotImplementedError("decode takes one new token per sequence")
    if cache is not None and static_cache:
        q = _project(p, x, "q", dtype)   # k and v of x are never read
        if rope_theta is not None:
            q = apply_rope(q, positions, rope_theta)
        lengths = torch.full((b,), cache["k"].shape[1], dtype=torch.int32, device=q.device)
        out = ops.decode_attention_bhsd(q, cache["k"], cache["v"], lengths)
        new_cache = cache
    else:
        q, k, v = _project_qkv(p, x, dtype, x_kv=x_kv)
        if rope_theta is not None:
            q = apply_rope(q, positions, rope_theta)
            if x_kv is None:   # self-attention: keys share the query positions
                k = apply_rope(k, positions, rope_theta)
        if cache is None:
            out = ops.flash_attention_bhsd(q, k, v, causal=causal, window=window)
            new_cache = {"k": k, "v": v}
        elif "k_scale" in cache:
            (kq, ks), (vq, vs) = _quantize_kv(k), _quantize_kv(v)
            names = ("k", "v", "k_scale", "v_scale")
            lengths = _cache_write([cache[n] for n in names], (kq, vq, ks, vs), cache_pos)
            out = ops.decode_attention_q8_bhsd(q, *(cache[n] for n in names), lengths)
            new_cache = cache
        else:
            lengths = _cache_write((cache["k"], cache["v"]), (k, v), cache_pos,
                                   ring=window is not None)
            out = ops.decode_attention_bhsd(q, cache["k"], cache["v"], lengths)
            new_cache = cache

    y = out.reshape(b, t, -1) @ _cast(p["wo"], dtype).reshape(-1, d)
    return y, new_cache


# --------------------------------------------------------------------------
# MLPs
# --------------------------------------------------------------------------


def mlp_apply(p, x, kind, dtype):
    if kind == "swiglu":
        h = F.silu(x @ _cast(p["w_gate"], dtype)) * (x @ _cast(p["w_up"], dtype))
    elif kind == "relu2":
        h = torch.square(F.relu(x @ _cast(p["w_up"], dtype)))
    elif kind == "gelu":
        h = F.gelu(x @ _cast(p["w_up"], dtype), approximate="tanh")  # jax.nn.gelu default
    else:
        raise ValueError(kind)
    return h @ _cast(p["w_down"], dtype)


# --------------------------------------------------------------------------
# embeddings
# --------------------------------------------------------------------------


def embed(p, tokens, dtype):
    return F.embedding(tokens, _cast(p["table"], dtype))


def unembed(p_head, x, dtype):
    """x (b, t, d) -> logits (b, t, V); head weight (d, V)."""
    return x @ _cast(p_head["w"], dtype)
