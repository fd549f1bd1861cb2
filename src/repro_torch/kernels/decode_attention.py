"""Single-token GQA decode attention over a KV cache: a CUDA kernel written
by hand for Hopper (``csrc/decode_attention.cu``) beside its plain version.

Replaces the Pallas TPU kernel ``repro/kernels/decode_attention.py``
(``_decode_kernel`` and its wrapper ``decode_attention``).

What bounds it on an H100: bytes.  Each call streams the valid part of the
K and V caches once (at the serving shape, 8 sequences x 8 kv heads x 2048
positions x 128 x bf16 x 2 = 67 MB, about 20 us at 3.35 TB/s) and does 4
flops per cached element per query head, far below the tensor cores' line.
What the design does about it:

* the valid cache of each (sequence, kv head) is split into
  :func:`num_splits` ranges, one thread block each, so that about 128 blocks
  keep the 132 SMs streaming; the blocks of one (sequence, kv head) form a
  thread block cluster and merge their partial softmax states through
  distributed shared memory inside the same launch (one launch per call, no
  scratch); each block derives its range from ``lengths[b]`` on the device,
  so the host never reads the lengths;
* each block holds all ``q_per_kv`` query heads of the group, so each K/V
  element is read from device memory once per group, not once per query
  head (the Pallas kernel's GQA property);
* K and V are read through strides straight from the model's
  ``(B, S, Hkv, d)`` cache, in 16-byte ``cp.async`` copies into a 3-stage
  ring of tiles kept in their own dtype, so loads overlap the math: the
  reference's layout wrapper transposed the whole cache on every call,
  which would double the bytes moved;
* bf16 runs both products on the tensor cores (``mma.sync``, the group
  padded to 16 rows), float32 on the CUDA cores; the softmax is online in
  float32.

:func:`decode_attention_q8` reads the reference's int8 ``kv_quant`` cache
(``repro/models/layers.py:269-301``): int8 K/V and one float32 scale per
(sequence, position, kv head) vector, half the bf16 cache's bytes plus the
scales (its bound).  The same kernel takes the int8 rows (16 a ``cp.async``)
and their scales into a ring of their own and widens each tile in shared
memory to the compute dtype as the reference dequantizes,
``dtype(x) * dtype(scale)``, before the unchanged body consumes it.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import (
    NEG_INF,
    decode_attention_q8_ref,
    decode_attention_ref,
    dequantize_kv,
)

HEAD_DIMS = (32, 64, 80, 128, 192)
MAX_Q_PER_KV = 16
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "ham_decode_attention":
        [_P] * 5 + [_I] * 7 + [_L] * 12 + [_P, _I, _P],
    "ham_decode_attention_q8":
        [_P] * 7 + [_I] * 7 + [_L] * 18 + [_P, _I, _P],
}

#: cluster sizes the kernel takes (portable: at most 8 blocks a cluster)
SPLITS = (1, 2, 4, 8)
#: blocks a launch aims at: about one per SM of the H100's 132.  On the
#: card more splits lose beyond that (each adds a block's prologue and a
#: merge); ``chip_smoke.py`` times every cluster size at the serving shapes
TARGET_BLOCKS = 128

#: kernel launches made by :func:`decode_attention` and
#: :func:`decode_attention_q8` (plain calls not counted)
launches = 0
#: of those, the launches over an int8 cache
launches_q8 = 0


def num_splits(groups: int) -> int:
    """Blocks (one thread block cluster) per (sequence, kv head) for a call
    over ``groups = B * Hkv`` of them: the fewest of :data:`SPLITS` that
    reach :data:`TARGET_BLOCKS`, else the most.  Known on the host from the
    shapes alone, so choosing it never waits for the device."""
    for s in SPLITS:
        if groups * s >= TARGET_BLOCKS:
            return s
    return SPLITS[-1]


def decode_attention_lse_plain(q, k, lengths):
    """Each query row's log-sum-exp (natural log) of its scaled scores over
    keys j < lengths[b]: float32 (B, Hkv, qpk), what the kernel writes with
    ``lse=``."""
    d, S = q.shape[-1], k.shape[2]
    s = torch.einsum("bhgd,bhsd->bhgs", q.float(), k.float()) / math.sqrt(d)
    valid = torch.arange(S, device=q.device) < lengths.reshape(-1, 1, 1, 1)
    return torch.logsumexp(torch.where(valid, s, NEG_INF), dim=-1)


def decode_attention_plain(q, k, v, lengths, lse=None):
    """The plain PyTorch version, same signature as :func:`decode_attention`."""
    B, Hkv, qpk, d = q.shape
    out = decode_attention_ref(
        q.reshape(B, Hkv * qpk, d), k, v, lengths, q_per_kv=qpk
    )
    if lse is not None:
        lse.copy_(decode_attention_lse_plain(q, k, lengths))
    return out.reshape(B, Hkv, qpk, d)


def decode_attention(q, k, v, lengths, lse=None):
    """q: (B, Hkv, qpk, d); k/v: (B, Hkv, S, d), any strides with a unit
    last dim; lengths: (B,) int.  Key j of sequence b is attended iff
    ``j < lengths[b]``; a length >= S attends the whole cache, and lengths
    must be >= 1.  Returns (B, Hkv, qpk, d).  ``lse``, a contiguous float32
    (B, Hkv, qpk) tensor, receives each row's log-sum-exp (the statistics a
    sequence-sharded cache merges its shards by); None writes nothing.

    CPU tensors take the plain version; CUDA tensors launch the kernel.
    """
    if _build.takes_plain(q):
        return decode_attention_plain(q, k, v, lengths, lse)
    _build.no_backward("decode_attention", "12d", q, k, v)
    return _launch(q, k, v, lengths, lse=lse)


def decode_attention_q8_plain(q, k, v, k_scale, v_scale, lengths, lse=None):
    """The plain PyTorch version, same signature as :func:`decode_attention_q8`."""
    B, Hkv, qpk, d = q.shape
    out = decode_attention_q8_ref(
        q.reshape(B, Hkv * qpk, d), k, v, k_scale, v_scale, lengths, q_per_kv=qpk
    )
    if lse is not None:
        lse.copy_(decode_attention_lse_plain(q, dequantize_kv(k, k_scale, q.dtype), lengths))
    return out.reshape(B, Hkv, qpk, d)


def decode_attention_q8(q, k, v, k_scale, v_scale, lengths, lse=None):
    """:func:`decode_attention` over an int8 cache: q (B, Hkv, qpk, d)
    float32 or bf16; k/v int8 (B, Hkv, S, d), any strides with a unit last
    dim; k_scale/v_scale float32 (B, Hkv, S, 1), any strides.  K and V are
    dequantized to q's dtype as the reference does, ``dtype(x) *
    dtype(scale)``.  Returns (B, Hkv, qpk, d); ``lse`` as for
    :func:`decode_attention`.

    CPU tensors take the plain version; CUDA tensors launch the kernel.
    """
    if _build.takes_plain(q):
        return decode_attention_q8_plain(q, k, v, k_scale, v_scale, lengths, lse)
    _build.no_backward("decode_attention_q8", "12d", q, k, v, k_scale, v_scale)
    return _launch(q, k, v, lengths, scales=(k_scale, v_scale), lse=lse)


def _check_shapes(q, k, v, lengths):
    B, Hkv, qpk, d = q.shape
    S = k.shape[2]
    if not (lengths.is_cuda and lengths.device == q.device):
        raise ValueError("decode_attention kernel needs lengths on q's CUDA device")
    if k.shape != (B, Hkv, S, d) or v.shape != k.shape or lengths.shape != (B,):
        raise ValueError(f"decode_attention shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)} "
                         f"lengths {tuple(lengths.shape)}")
    if d not in HEAD_DIMS or not 1 <= qpk <= MAX_Q_PER_KV:
        raise ValueError(f"decode_attention kernel takes head_dim in {HEAD_DIMS} "
                         f"and q_per_kv <= {MAX_Q_PER_KV}, got {d}, {qpk}")


def _check_lse(q, lse):
    if lse is not None and (lse.dtype != torch.float32 or lse.device != q.device
                            or lse.shape != q.shape[:3] or not lse.is_contiguous()):
        raise ValueError(f"decode_attention lse must be contiguous float32 "
                         f"{tuple(q.shape[:3])} on {q.device}, got {lse.dtype} "
                         f"{tuple(lse.shape)} on {lse.device}")


@_build.counted
def _launch(q, k, v, lengths, splits=None, scales=None, lse=None):
    """Launch the kernel (the int8 variant when ``scales`` =
    ``(k_scale, v_scale)`` is given); ``splits`` (one of :data:`SPLITS`)
    overrides :func:`num_splits`, for timing the cluster sizes against each
    other; ``lse`` receives the rows' log-sum-exp."""
    if scales is not None:
        return _launch_q8(q, k, v, lengths, splits, *scales, lse=lse)
    B, Hkv, qpk, d = q.shape
    S = k.shape[2]
    dtype = _build.check_inputs("decode_attention", (q, k, v))
    _check_shapes(q, k, v, lengths)
    _check_lse(q, lse)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lengths = lengths.to(torch.int32).contiguous()
    lib = _build.library("decode_attention", _SIGNATURES)
    err = lib.ham_decode_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
        out.data_ptr(), B, Hkv, qpk, S, d, dtype, splits or num_splits(B * Hkv),
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        None if lse is None else lse.data_ptr(),
        q.device.index, torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(lib, err, "decode_attention")
    return out


def _launch_q8(q, k, v, lengths, splits, k_scale, v_scale, lse=None):
    B, Hkv, qpk, d = q.shape
    S = k.shape[2]
    dtype = _build.check_inputs("decode_attention_q8", (q,))
    _build.check_aux("decode_attention_q8", q, (k, v), torch.int8, "k/v")
    _build.check_aux("decode_attention_q8", q, (k_scale, v_scale), torch.float32, "scales")
    if not all(t.stride(-1) == 1 and _build._aligned(t) for t in (k, v)):
        raise ValueError("decode_attention_q8 kernel needs int8 k/v with a unit last-dim "
                         "stride and 16-byte aligned rows")
    _check_shapes(q, k, v, lengths)
    _check_lse(q, lse)
    if k_scale.shape != (B, Hkv, S, 1) or v_scale.shape != k_scale.shape:
        raise ValueError(f"decode_attention_q8 scales {tuple(k_scale.shape)} "
                         f"{tuple(v_scale.shape)}, want {(B, Hkv, S, 1)}")
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lengths = lengths.to(torch.int32).contiguous()
    lib = _build.library("decode_attention", _SIGNATURES)
    err = lib.ham_decode_attention_q8(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), k_scale.data_ptr(), v_scale.data_ptr(),
        lengths.data_ptr(), out.data_ptr(), B, Hkv, qpk, S, d, dtype,
        splits or num_splits(B * Hkv),
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        *k_scale.stride()[:3], *v_scale.stride()[:3],
        None if lse is None else lse.data_ptr(),
        q.device.index, torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(lib, err, "decode_attention_q8")
    _build.count(__name__, "launches_q8")
    return out
