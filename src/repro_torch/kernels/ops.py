"""Model-layout wrappers over the kernels (port of ``repro.kernels.ops``).

The model keeps activations and the KV cache as ``(B, S, heads, d)``.  The
reference's wrappers transposed q/k/v (and, for decode, the whole cache)
into the kernels' head-major layout on every call; here the kernels read
strided views, so the wrappers only reshape and transpose views and
allocate the output in the model's layout.  The MoE layer's dispatched
tokens carry a group dim, ``(G, E, C, d)``, which the grouped-matmul kernel
folds into its capacity dim.  The mLSTM kernel reads q/k/v and the gates
of the model's ``(B, S, H, ...)`` layout in place and writes h into it.
The SSD kernel reads x, B and C as strided views of the Mamba2 block's conv
output, indexes B/C groups per head itself (the reference wrapper repeated
them per head and transposed everything) and fuses the D x skip, rounding y
once as the reference model does.

A CPU tensor takes the kernel's plain version; a CUDA tensor launches the
kernel (each kernel module keeps its launch counter).  Under autograd a
CUDA call of flash attention, the grouped matmul, the mLSTM or the SSD
records its backward kernels; the decode kernels have none yet and raise.

DTensors (a model run under a ``Sharder``) run on their local shards: a
wrapper takes ``to_local()`` of each input (differentiable, outside the
autograd Functions, which see plain tensors), calls the kernel on the
shard and wraps the result back with the matching placements.  That is
sound where only batch, heads or experts are split; a layout that splits a
dimension the kernel reduces over (the head dim, a sequence the kernel
scans, the grouped matmul's contraction except against an equally split
weight) raises by name and is never gathered quietly.  Two layouts reduce
across ranks on purpose: TP-in-expert's down projection, whose local
product over the split ``f`` is a ``Partial`` sum, and a decode cache whose
*sequence* is split, whose shards' partial softmax states are merged by
their rows' log-sum-exp (the decode kernel's ``lse`` output).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import grouped_matmul as gmm
from repro_torch.kernels import mamba2_ssd as _ssd
from repro_torch.kernels import mlstm as _mlstm
from repro_torch.kernels.decode_attention import decode_attention, decode_attention_q8
from repro_torch.kernels.flash_attention import flash_attention_heads
from repro_torch.core.dtensor import is_dtensor, local_offset


def flash_attention_bhsd(q, k, v, *, causal=True, window=None):
    """q (B, Sq, H, hd); k/v (B, Skv, Hkv, hd) -> (B, Sq, H, hd).  Cross
    attention (Sq != Skv) is non-causal; ``window`` applies only when
    causal."""
    if is_dtensor(q):
        return _sharded_heads("flash_attention", flash_attention_bhsd, q, (k, v), (),
                              causal=causal, window=window)
    t = lambda a: a.transpose(1, 2)
    return t(flash_attention_heads(t(q), t(k), t(v), causal=causal, window=window))


def decode_attention_bhsd(q, k, v, lengths, lse=None):
    """q (B, 1, H, hd); k/v caches (B, S, Hkv, hd); lengths (B,) ->
    (B, 1, H, hd).  The cache is read in place through strides; ``lse``
    (float32 (B, H), contiguous) receives the rows' log-sum-exp."""
    if is_dtensor(k):
        return _sharded_decode(decode_attention_bhsd, q, (k, v), lengths)
    B, _, H, hd = q.shape
    Hkv = k.shape[2]
    q4 = q.reshape(B, Hkv, H // Hkv, hd)
    out = decode_attention(q4, k.transpose(1, 2), v.transpose(1, 2), lengths,
                           None if lse is None else lse.view(B, Hkv, H // Hkv))
    return out.reshape(B, 1, H, hd)


def decode_attention_q8_bhsd(q, k, v, k_scale, v_scale, lengths, lse=None):
    """:func:`decode_attention_bhsd` over an int8 cache: k/v int8 (B, S,
    Hkv, hd), k_scale/v_scale float32 (B, S, Hkv, 1), all read in place
    through strides."""
    if is_dtensor(k):
        return _sharded_decode(decode_attention_q8_bhsd, q, (k, v, k_scale, v_scale), lengths)
    B, _, H, hd = q.shape
    Hkv = k.shape[2]
    t = lambda a: a.transpose(1, 2)
    out = decode_attention_q8(q.reshape(B, Hkv, H // Hkv, hd), t(k), t(v), t(k_scale),
                              t(v_scale), lengths,
                              None if lse is None else lse.view(B, Hkv, H // Hkv))
    return out.reshape(B, 1, H, hd)


def grouped_matmul(x, w):
    """x (G, E, C, d) dispatched tokens; w (E, d, f) expert weights ->
    (G, E, C, f), the reference model's ``einsum("gecd,edf->gecf")``.

    G folds into the capacity dim, (E, G*C, d), since w has no G: a view when
    G == 1 (every serving shape), one copy otherwise.  The result is a view
    of the kernel's (E, G*C, f) output.
    """
    if is_dtensor(x):
        return _sharded_grouped_matmul(x, w)
    G, E, C, d = x.shape
    out = gmm.grouped_matmul(x.transpose(0, 1).reshape(E, G * C, d), w)
    return out.view(E, G, C, -1).transpose(0, 1)


def mlstm_chunked(q, k, v, i_pre, f_pre, state=None, *, chunk=256):
    """Model layout: q, k (B, S, H, dk); v (B, S, H, dv); gates (B, S, H);
    state (C (B,H,dk,dv), n (B,H,dk), m (B,H)) or None.  Returns
    (h (B, S, H, dv), (C, n, m)).  The kernel takes ``chunk`` with a masked
    ragged tail; the plain version shrinks it to divide S.  Without autograd
    the kernel writes h into a tensor of the model's layout; under autograd
    h is the autograd Function's output (a write through ``out`` would cut
    the graph)."""
    if is_dtensor(q):
        return _sharded_scan("mlstm", mlstm_chunked, (q, k, v, i_pre, f_pre), state,
                             chunk=chunk)
    t = lambda a: a.transpose(1, 2)
    out = None
    if not _build.grad_wanted(q, k, v, i_pre, f_pre, *(state or ())):
        out = t(torch.empty(v.shape, dtype=v.dtype, device=v.device))
    h, st = _mlstm.mlstm_chunked_heads(t(q), t(k), t(v), t(i_pre), t(f_pre), state,
                                       chunk=chunk, out=out)
    return t(h), st


def ssd_chunked(x, dt, A, Bm, Cm, D, state=None, *, chunk=256):
    """Model layout: x (B, S, H, P); dt (B, S, H) float32; A, D (H,)
    float32; Bm, Cm (B, S, G, N); state h (B, H, N, P) float32 or None.
    Returns (y (B, S, H, P) with the D x skip, h).  The kernel takes
    ``chunk`` with a masked ragged tail; the plain version shrinks it to
    divide S."""
    if is_dtensor(x):
        return _sharded_ssd(x, dt, A, Bm, Cm, D, state, chunk=chunk)
    return _ssd.ssd_chunked(x, dt, A, Bm, Cm, D, state, chunk=chunk)


# -- DTensors: the kernels on local shards -----------------------------------------


def _check_layout(name, t, allowed) -> None:
    """Raise unless every placement of the DTensor ``t`` is ``Replicate()``
    or ``Shard(d)`` with d in ``allowed`` (the dims the kernel keeps apart)."""
    names = t.device_mesh.mesh_dim_names
    for j, pl in enumerate(t.placements):
        if pl.is_replicate() or (pl.is_shard() and pl.dim % t.ndim in allowed):
            continue
        what = "partial sums" if pl.is_partial() else f"dim {pl.dim}"
        raise NotImplementedError(
            f"{name} runs on local shards and cannot take {what} of a "
            f"{tuple(t.shape)} input split over mesh axis {names[j]!r}: the kernel "
            f"reduces over it (redistribute first)")


def _wrap(local, mesh, placements):
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(local, mesh, placements, run_check=False)


def _head_slice(name, h0, n_heads, per_group, g0, n_groups):
    """The local slice of a grouped operand (kv heads, B/C groups) that the
    query heads [h0, h0 + n_heads) read, query head h reading group
    ``h // per_group``, when the local groups are [g0, g0 + n_groups)."""
    a, b = h0 // per_group, (h0 + n_heads - 1) // per_group + 1
    aligned = (n_heads % per_group == 0 and h0 % per_group == 0) if n_heads >= per_group \
        else b - a == 1
    if not aligned or a < g0 or b > g0 + n_groups:
        raise NotImplementedError(
            f"{name}: local heads [{h0}, {h0 + n_heads}) do not map onto whole local "
            f"groups [{g0}, {g0 + n_groups}) of {per_group} heads each")
    return slice(a - g0, b - g0)


def _grouped_local(name, q, grouped, head_dim, group_dim):
    """Local shards of ``grouped`` (operands whose ``group_dim`` holds the
    groups q's heads (``head_dim``) read) sliced to the groups q's local
    heads read.  A grouped operand replicated where q's heads are split
    reads a slice on each rank: its gradient there is a partial sum."""
    from torch.distributed.tensor import Partial

    out = []
    h0, n_heads = local_offset(q)[head_dim], q.to_local().shape[head_dim]
    for g in grouped:
        grad = []
        for j, (a, b) in enumerate(zip(q.placements, g.placements)):
            if a.is_shard(head_dim) and b.is_replicate():
                grad.append(Partial())
            elif (a.is_shard(head_dim) and b.is_shard(group_dim)) or a == b:
                grad.append(b)
            else:
                raise NotImplementedError(
                    f"{name}: operand placements {tuple(g.placements)} do not follow the "
                    f"query's {tuple(q.placements)} on mesh dim {j}")
        local = g.to_local(grad_placements=grad)
        per_group = q.shape[head_dim] // g.shape[group_dim]
        sl = _head_slice(name, h0, n_heads, per_group, local_offset(g)[group_dim],
                         local.shape[group_dim])
        out.append(local.narrow(group_dim, sl.start, sl.stop - sl.start))
    return out


def _sharded_heads(name, fn, q, grouped, rest, **kw):
    """``fn`` on the local shards of q (B, S, H, ...) split over batch and
    heads, its grouped operands (B, S, G, ...) sliced to the local heads'
    groups; the result (B, S, H, ...) takes q's placements."""
    for t in (q, *grouped, *rest):
        _check_layout(name, t, (0, 2))
    local = _grouped_local(name, q, grouped, 2, 2)
    out = fn(q.to_local(), *local, *(t.to_local() for t in rest), **kw)
    return _wrap(out, q.device_mesh, q.placements)


def _cache_placements(cache):
    """Placements for a decode query (or new token) that line up with a
    (B, S, Hkv, ...) cache shard: batch and heads split as the cache's,
    replicated where the cache splits its sequence."""
    from torch.distributed.tensor import Replicate

    return [pl if pl.is_shard(0) or pl.is_shard(2) else Replicate()
            for pl in cache.placements]


def local_like_cache(x, cache):
    """The local shard of ``x`` (B, t, heads, ...) redistributed to line up
    with the cache shard (:func:`_cache_placements`)."""
    return x.redistribute(x.device_mesh, _cache_placements(cache)).to_local()


def cache_extent(cache):
    """(first global batch row, first global position, local positions) of
    a cache shard."""
    off = local_offset(cache)
    return off[0], off[1], cache.to_local().shape[1]


def _sharded_decode(fn, q, cache, lengths):
    """Decode over a DTensor cache (B, S, Hkv, ...) split over batch, kv
    heads or sequence.  q is redistributed to line up with the cache
    (replicated where the sequence is split; it is one token).  Each rank
    attends its positions; where the sequence is split over mesh axes
    larger than one, each shard also writes its rows' log-sum-exp and the
    shards merge across each such axis: all-gather the (B, H) statistics
    and outputs, weight each shard's output by exp(lse - max)."""
    name = "decode_attention"
    for t in cache:
        _check_layout(name, t, (0, 1, 2))
    mesh = cache[0].device_mesh
    placements = _cache_placements(cache[0])
    ql = q.redistribute(mesh, placements).to_local()
    b0, s0, S_loc = cache_extent(cache[0])
    lengths = torch.as_tensor(lengths, device=ql.device)
    lengths = lengths.expand(q.shape[0])[b0:b0 + ql.shape[0]]
    local_len = (lengths - s0).clamp(0, S_loc).to(torch.int32)
    split = [j for j, pl in enumerate(cache[0].placements)
             if pl.is_shard(1) and mesh.size(j) > 1]
    locals_ = [t.to_local() for t in cache]
    if not split:
        out = fn(ql, *locals_, local_len)
        return _wrap(out, mesh, placements)
    B, _, H, _ = ql.shape
    lse = torch.empty((B, H), dtype=torch.float32, device=ql.device)
    out = fn(ql, *locals_, local_len.clamp(min=1), lse=lse)
    lse = torch.where((local_len > 0)[:, None], lse, float("-inf"))
    out = out.float()
    for j in split:
        out, lse = _merge_softmax_shards(out, lse, mesh, j)
    return _wrap(out.to(ql.dtype), mesh, placements)


def _merge_softmax_shards(out, lse, mesh, dim):
    """Merge per-shard attention outputs (B, 1, H, hd) float32 and their
    rows' log-sum-exp (B, H) across mesh dim ``dim``."""
    import torch.distributed._functional_collectives as funcol

    gather = getattr(funcol, "all_gather_single", None) or funcol.all_gather_tensor
    outs = gather(out[None].contiguous(), 0, (mesh, dim))
    lses = gather(lse[None].contiguous(), 0, (mesh, dim))
    top = lses.max(dim=0).values
    top = torch.where(torch.isfinite(top), top, torch.zeros_like(top))
    w = torch.exp(lses - top)                                    # (n, B, H)
    total = w.sum(dim=0)
    merged = (w[:, :, None, :, None] * outs).sum(dim=0) / total[:, None, :, None]
    return merged, top + torch.log(total)


def _sharded_grouped_matmul(x, w):
    """x (G, E, C, d) and w (E, d, f) on their local shards.  Per mesh dim:
    groups split (w replicated), experts split on both (EP), f split on w
    (TP-in-expert: the output's f split), or the contraction split on both
    (TP-in-expert's down projection: the local product is a partial sum,
    returned ``Partial``).  Anything else raises."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    name = "grouped_matmul"
    _check_layout(name, x, (0, 1, 3))
    _check_layout(name, w, (0, 1, 2))
    out_pl, x_grad, w_grad = [], [], []
    for j, (a, b) in enumerate(zip(x.placements, w.placements)):
        if a.is_replicate() and b.is_replicate():
            out_pl.append(Replicate()); x_grad.append(a); w_grad.append(b)
        elif a.is_shard(0) and b.is_replicate():
            out_pl.append(Shard(0)); x_grad.append(a); w_grad.append(Partial())
        elif a.is_shard(1) and b.is_shard(0):
            out_pl.append(Shard(1)); x_grad.append(a); w_grad.append(b)
        elif a.is_replicate() and b.is_shard(2):
            out_pl.append(Shard(3)); x_grad.append(Partial()); w_grad.append(b)
        elif a.is_shard(3) and b.is_shard(1):
            out_pl.append(Partial()); x_grad.append(a); w_grad.append(b)
        else:
            raise NotImplementedError(
                f"{name}: x placements {tuple(x.placements)} and w placements "
                f"{tuple(w.placements)} on mesh dim {j} split the contraction or "
                f"disagree on the experts")
    out = grouped_matmul(x.to_local(grad_placements=x_grad), w.to_local(grad_placements=w_grad))
    return _wrap(out, x.device_mesh, out_pl)


def _state_placements(placements, head_dim_of_state):
    """Placements of a scan state (B, H, ...) given its input's (B, S, H, ...)."""
    from torch.distributed.tensor import Shard

    return [Shard(head_dim_of_state) if pl.is_shard(2) else pl for pl in placements]


def _sharded_scan(name, fn, inputs, state, **kw):
    """The mLSTM on local shards: q, k, v (B, S, H, d) and the gates (B, S,
    H) split alike over batch and heads; the state (C (B, H, dk, dv), n, m)
    split to match."""
    q = inputs[0]
    for t in inputs:
        _check_layout(name, t, (0, 2))
        if tuple(t.placements) != tuple(q.placements):
            raise NotImplementedError(f"{name}: inputs split differently: "
                                      f"{tuple(t.placements)} vs {tuple(q.placements)}")
    st_pl = _state_placements(q.placements, 1)
    local_state = None
    if state is not None:
        local_state = tuple(s.redistribute(s.device_mesh, st_pl).to_local() for s in state)
    h, st = fn(*(t.to_local() for t in inputs), local_state, **kw)
    mesh = q.device_mesh
    return _wrap(h, mesh, q.placements), tuple(_wrap(s, mesh, st_pl) for s in st)


def _sharded_ssd(x, dt, A, Bm, Cm, D, state, *, chunk):
    """The SSD on local shards: x (B, S, H, P) and dt (B, S, H) split alike
    over batch and heads, A and D (H,) sliced to the local heads, B and C
    (B, S, G, N) to the groups the local heads read."""
    name = "ssd"
    for t in (x, dt, Bm, Cm):
        _check_layout(name, t, (0, 2))
    if tuple(dt.placements) != tuple(x.placements):
        raise NotImplementedError(f"{name}: dt split {tuple(dt.placements)}, x "
                                  f"{tuple(x.placements)}")
    Bl, Cl = _grouped_local(name, x, (Bm, Cm), 2, 2)
    h0, n = local_offset(x)[2], x.to_local().shape[2]
    Al, Dl = (_heads_of(t, x, h0, n) for t in (A, D))
    st_pl = _state_placements(x.placements, 1)
    local_state = None
    if state is not None:
        local_state = state.redistribute(state.device_mesh, st_pl).to_local()
    y, h = ssd_chunked(x.to_local(), dt.to_local(), Al, Bl, Cl, Dl, local_state, chunk=chunk)
    mesh = x.device_mesh
    return _wrap(y, mesh, x.placements), _wrap(h, mesh, st_pl)


def _heads_of(t, x, h0, n):
    """The local heads [h0, h0 + n) of a per-head (H,) operand, replicated
    (a plain tensor, or a replicated DTensor whose gradient is then a
    partial sum where x's heads are split)."""
    from torch.distributed.tensor import Partial, Replicate

    if not is_dtensor(t):
        return t[h0:h0 + n]
    if any(not pl.is_replicate() for pl in t.placements):
        raise NotImplementedError(f"ssd: per-head operands must be replicated, got "
                                  f"{tuple(t.placements)}")
    grad = [Partial() if pl.is_shard() else Replicate() for pl in x.placements]
    return t.to_local(grad_placements=grad)[h0:h0 + n]
