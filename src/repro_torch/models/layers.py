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
from repro_torch.core.dtensor import flatten, is_dtensor, local_offset


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


def _project(p, x, name, dtype, sharder=None):
    """x (b, t, d) @ p[w<name>] (d, heads, hd) (+ p[b<name>]) -> (b, t, heads, hd).
    On a mesh the flat product first takes the heads layout's placements,
    so that its split (if any) falls on whole heads."""
    b, t, d = x.shape
    w = p["w" + name]
    y = x @ flatten(_cast(w, dtype), 1, -1)
    if sharder is not None:
        heads = sharder.placements((b, t, *w.shape[1:]), ["batch", None, "model", None])
        if tuple(y.placements) != tuple(heads):
            y = y.redistribute(y.device_mesh, heads)
    y = y.view(b, t, *w.shape[1:])
    return y + _cast(p["b" + name], dtype) if "b" + name in p else y


def _project_qkv(p, x, dtype, x_kv=None, sharder=None):
    xkv = x if x_kv is None else x_kv
    return tuple(_project(p, a, n, dtype, sharder) for a, n in ((x, "q"), (xkv, "k"), (xkv, "v")))


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
    if is_dtensor(caches[0]):
        return _cache_write_sharded(caches, news, cache_pos, ring=ring)
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


def _cache_write_sharded(caches, news, cache_pos, *, ring=False):
    """:func:`_cache_write` into DTensor caches (B, S, ...) split over batch,
    heads or sequence: the new token (redistributed to line up with the
    cache shard) is written by the rank that holds its global slot, at the
    slot :func:`_cache_write` would pick.  Returns the global lengths (B,)
    of the whole cache (the decode wrapper clips them to each shard)."""
    B, S = caches[0].shape[0], caches[0].shape[1]
    b0, s0, S_loc = ops.cache_extent(caches[0])
    locs = [c.to_local() for c in caches]
    dev = locs[0].device
    pos = cache_pos.full_tensor() if is_dtensor(cache_pos) else cache_pos
    pos = torch.as_tensor(pos, device=dev).to(torch.int64)
    lengths = (pos + 1).clamp(max=S).expand(B).to(torch.int32)
    if pos.ndim == 1:
        pos = pos[b0:b0 + locs[0].shape[0]]
        slot, keep = (pos % S, pos >= 0) if ring else (pos.clamp(max=S - 1), pos < S)
    else:
        slot = (pos % S if ring else pos.clamp(0, S - 1)).expand(locs[0].shape[0])
        keep = torch.ones_like(slot, dtype=torch.bool)
    local = slot - s0
    keep = keep & (local >= 0) & (local < S_loc)
    idx = local.clamp(0, S_loc - 1)
    bidx = torch.arange(locs[0].shape[0], device=dev)
    for c, n, full in zip(locs, news, caches):
        n = ops.local_like_cache(n, full)
        mask = keep.view(-1, *[1] * (c.ndim - 2))
        c[bidx, idx] = torch.where(mask, n[:, 0], c[bidx, idx])
    return lengths


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
    sharder=None,
):
    """Full/causal/cross attention with an optional KV cache.  Head counts
    come from the weights: ``wq (d, H, hd)``, ``wk/wv (d, Hkv, hd)``.
    With a ``sharder`` every tensor is a DTensor: q, k, v and the output
    take the reference's ``["batch", None, "model", None]`` layout and the
    kernels run on the local shards (:mod:`repro_torch.kernels.ops`).

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
    heads = ["batch", None, "model", None]
    if cache is not None and static_cache:
        q = _project(p, x, "q", dtype, sharder)   # k and v of x are never read
        if rope_theta is not None:
            q = apply_rope(q, positions, rope_theta)
        if sharder is not None:
            q = sharder.constrain(q, heads)
        lengths = torch.full((b,), cache["k"].shape[1], dtype=torch.int32, device=q.device)
        out = ops.decode_attention_bhsd(q, cache["k"], cache["v"], lengths)
        new_cache = cache
    else:
        q, k, v = _project_qkv(p, x, dtype, x_kv=x_kv, sharder=sharder)
        if rope_theta is not None:
            q = apply_rope(q, positions, rope_theta)
            if x_kv is None:   # self-attention: keys share the query positions
                k = apply_rope(k, positions, rope_theta)
        if sharder is not None:
            q, k, v = (sharder.constrain(t, heads) for t in (q, k, v))
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

    if sharder is not None:
        out = sharder.constrain(out, heads)
    y = flatten(out, 2, 3) @ flatten(_cast(p["wo"], dtype), 0, 1)
    if sharder is not None:
        y = sharder.act_btd(y)
    return y, new_cache


# --------------------------------------------------------------------------
# MLPs
# --------------------------------------------------------------------------


def mlp_apply(p, x, kind, dtype, sharder=None):
    if kind == "swiglu":
        h = F.silu(x @ _cast(p["w_gate"], dtype)) * (x @ _cast(p["w_up"], dtype))
    elif kind == "relu2":
        h = torch.square(F.relu(x @ _cast(p["w_up"], dtype)))
    elif kind == "gelu":
        h = F.gelu(x @ _cast(p["w_up"], dtype), approximate="tanh")  # jax.nn.gelu default
    else:
        raise ValueError(kind)
    if sharder is not None:
        # the reference constrains h to ["batch", "seq", "model"]; under
        # sequence parallelism "seq" would take the model axis and leave f
        # whole.  The projections read whole sequences here (the stream is
        # gathered before them, transformer._gathered), so h splits f
        h = sharder.constrain(h, ["batch", None, "model"])
    y = h @ _cast(p["w_down"], dtype)
    if sharder is not None:
        y = sharder.act_btd(y)
    return y


# --------------------------------------------------------------------------
# embeddings
# --------------------------------------------------------------------------


def embed(p, tokens, dtype):
    return F.embedding(tokens, _cast(p["table"], dtype))


def unembed(p_head, x, dtype):
    """x (b, t, d) -> logits (b, t, V); head weight (d, V)."""
    return x @ _cast(p_head["w"], dtype)


def _labels_like(placements, last):
    """Placements for the labels (B, S) of logits placed ``placements``:
    their batch/sequence splits, replicated where the vocab is split."""
    from torch.distributed.tensor import Replicate

    return [Replicate() if q.is_shard(last) or q.is_partial() else q for q in placements]


class _VocabLogSumExp(torch.autograd.Function):
    """The rows' log-sum-exp of local logits (B, S, V_local) whose vocab may
    be split over ranks; ``reduce(t, op)`` reduces a (B, S) local tensor
    across those ranks.  Forward and backward are ``torch.logsumexp``'s own
    formulas (the max masked where infinite; the gradient
    ``g * exp(x - lse)``), so a vocab held whole by one rank gives its
    results bit for bit."""

    @staticmethod
    def forward(ctx, local, reduce):
        top = reduce(local.amax(dim=-1), "max")
        top = top.masked_fill(top.abs() == math.inf, 0.0)
        lse = torch.log(reduce(torch.exp(local - top[..., None]).sum(dim=-1), "sum")) + top
        ctx.save_for_backward(local, lse)
        return lse

    @staticmethod
    def backward(ctx, g):
        local, lse = ctx.saved_tensors
        return (local - lse[..., None]).exp_().mul_(g[..., None]), None


def _ce_terms_sharded(logits, labels):
    """(logsumexp, logits at ``labels``) of DTensor logits (B, S, V) over
    their last dim, on the local shards: the logits are never gathered,
    forward or backward.  The row max and the sum of exponentials reduce
    across the mesh dims that split the vocab ((B, S) all-reduces) and each
    rank gathers the labels in its vocab range (a partial sum)."""
    from torch.distributed.tensor import DTensor, Partial

    mesh, pl = logits.device_mesh, logits.placements
    last = logits.ndim - 1
    rows = _labels_like(pl, last)
    local = logits.to_local()
    labels = labels.redistribute(mesh, rows).to_local()

    def reduce(t, op):
        part = [Partial(op) if q.is_shard(last) else q for q in pl]
        return DTensor.from_local(t, mesh, part, run_check=False).redistribute(
            mesh, rows).to_local()

    logz = DTensor.from_local(_VocabLogSumExp.apply(local, reduce), mesh, rows, run_check=False)
    off = local_offset(logits)[last]
    mine = (labels >= off) & (labels < off + local.shape[-1])
    picked = torch.gather(local, -1, torch.where(mine, labels - off, 0)[..., None])[..., 0]
    gold = DTensor.from_local(torch.where(mine, picked, 0.0), mesh,
                              [Partial() if q.is_shard(last) else q for q in pl], run_check=False)
    return logz, gold


def cross_entropy(logits, labels, *, z_loss: float = 0.0):
    """Mean token cross-entropy in float32; labels -100 are ignored."""
    logits = logits.float()
    valid = labels >= 0
    safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
    if is_dtensor(logits):
        logz, gold = _ce_terms_sharded(logits, safe)
    else:
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, safe[..., None])[..., 0]
    loss = (logz - gold) * valid
    if z_loss:
        loss = loss + z_loss * logz.square() * valid
    return loss.sum() / valid.sum().clamp(min=1)
