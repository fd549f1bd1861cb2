"""Shared neural building blocks (port of ``repro.models.layers``).

Conventions, as in the reference:
* params are plain dicts of tensors in ``param_dtype``, with the reference's
  layouts: dense weights ``(in, out)``, ``wq/wk/wv (d, heads, hd)``,
  ``wo (heads, hd, d)``, KV caches ``(B, S, Hkv, hd)``;
* ``apply`` functions cast to the compute dtype at use sites and keep
  normalisation/softmax statistics in float32.

Attention goes through the kernel wrappers of :mod:`repro_torch.kernels.ops`:
flash attention for prefill/full attention, decode attention for one new
token per sequence over a linear cache.  Those launch the hand-written CUDA
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


def _project_qkv(p, x, dtype):
    b, t, d = x.shape
    q = (x @ _cast(p["wq"], dtype).reshape(d, -1)).view(b, t, *p["wq"].shape[1:])
    k = (x @ _cast(p["wk"], dtype).reshape(d, -1)).view(b, t, *p["wk"].shape[1:])
    v = (x @ _cast(p["wv"], dtype).reshape(d, -1)).view(b, t, *p["wv"].shape[1:])
    if "bq" in p:
        q = q + _cast(p["bq"], dtype)
        k = k + _cast(p["bk"], dtype)
        v = v + _cast(p["bv"], dtype)
    return q, k, v


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


def causal_mask(t, s, q_offset=0, window=None, device=None):
    """(1,1,1,t,s) boolean; query position i = q_offset + i attends to
    key positions j <= i (and j > i - window when windowed)."""
    qi = torch.arange(t, device=device)[:, None] + q_offset
    kj = torch.arange(s, device=device)[None, :]
    m = kj <= qi
    if window is not None:
        m = m & (kj > qi - window)
    return m[None, None, None]


def _cache_write(ck, cv, k, v, cache_pos):
    """Write the new token's k/v into the linear cache in place and return the
    per-sequence attended length, mirroring the reference exactly:

    * per-slot ``cache_pos`` (B,): a scatter at ``[b, pos[b]]``; a lane with
      ``pos >= S`` writes nothing (XLA drops out-of-bounds scatter updates);
    * scalar ``cache_pos``: ``dynamic_update_slice``, whose start clamps to
      ``[0, S - 1]``.

    The reference then masks key ``j <= pos``, which is the kernel's
    ``j < length`` with ``length = min(pos + 1, S)``.
    """
    B, S = ck.shape[0], ck.shape[1]
    pos = cache_pos.to(device=ck.device, dtype=torch.int64)
    if pos.ndim == 1:
        bidx = torch.arange(B, device=ck.device)
        idx = pos.clamp(max=S - 1)
        keep = (pos < S)[:, None, None]
        ck[bidx, idx] = torch.where(keep, k[:, 0], ck[bidx, idx])
        cv[bidx, idx] = torch.where(keep, v[:, 0], cv[bidx, idx])
    else:
        start = pos.clamp(0, S - 1).reshape(1)
        ck.index_copy_(1, start, k)
        cv.index_copy_(1, start, v)
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
    static_cache: bool = False,
):
    """Full/causal self-attention with an optional linear KV cache.  Head
    counts come from the weights: ``wq (d, H, hd)``, ``wk/wv (d, Hkv, hd)``.

    Modes:
    * prefill/full:  cache=None -> one flash-attention call over x; returns
                     the new cache ``{k, v}`` built from x (any length: the
                     reference's q-chunked path above ``attn_chunk``
                     computes the same math);
    * decode:        cache={'k','v'} (B, S, hk, hd); the one new token is
                     written at ``cache_pos`` — (B,) per slot or a scalar —
                     **in place**, then attends over the cache through the
                     decode kernel.  The returned cache is the same dict.

    Windowed ring caches, the int8 ``kv_quant`` cache and static cross caches
    are not ported yet and raise ``NotImplementedError``.
    """
    if window is not None:
        raise NotImplementedError("windowed (ring-buffer) attention is not ported yet")
    if static_cache:
        raise NotImplementedError("static cross-attention caches are not ported yet")
    if cache is not None and "k_scale" in cache:
        raise NotImplementedError("the int8 kv_quant cache is not ported yet")
    b, t, d = x.shape
    q, k, v = _project_qkv(p, x, dtype)
    if rope_theta is not None:
        q = apply_rope(q, positions, rope_theta)
        k = apply_rope(k, positions, rope_theta)

    if cache is None:
        out = ops.flash_attention_bhsd(q, k, v, causal=causal)
        new_cache = {"k": k, "v": v}
    else:
        if t != 1:
            raise NotImplementedError("decode takes one new token per sequence")
        lengths = _cache_write(cache["k"], cache["v"], k, v, cache_pos)
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
