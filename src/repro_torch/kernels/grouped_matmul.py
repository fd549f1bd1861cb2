"""Grouped (per-expert) matmul for the MoE layer: a CUDA kernel written by
hand for Hopper (``csrc/grouped_matmul.cu``) beside its plain version.

Replaces the Pallas TPU kernel ``repro/kernels/grouped_matmul.py``
(``_gmm_kernel`` and its wrapper ``grouped_matmul``): out[e] = x[e] @ w[e]
over the capacity-padded dispatch layout (E, C, d) x (E, d, f) -> (E, C, f),
accumulated in float32, the output in the input dtype.

What bounds it on an H100: bytes.  At decode (olmoe-1b-7b, 8 slots, C = 8)
each call streams all 64 expert matrices of one projection, 64 x 2048 x 1024
x 2 B = 268 MB, at least 80 us at 3.35 TB/s, for 2 flops per weight element
per token.  A 1024-token prefill (C = 160) does 42.9 GFLOP on ~331 MB: 43 us
at the bf16 tensor-core peak against 99 us of bytes, still bytes on paper.
What the design does about it:

* C <= 8 (decode) takes a skinny kernel: one block per (expert, 32 x 16
  bytes of f columns), each warp lane streaming one 16-byte column vector of
  w down its share of d with several loads in flight, x held in shared
  memory; w leaves device memory exactly once per call;
* larger C (prefill) in bfloat16 takes 64 x 128 tiles on the tensor cores
  (``mma.sync`` with float32 accumulators, a 3-stage ``cp.async`` ring);
  in float32 the same tiling runs on the CUDA cores, since the tensor cores
  take float32 only as TF32;
* the skinny kernel multiplies on the CUDA cores in float32 (the Pallas
  kernel also upcast to float32); all read x and w through strides, so a
  layer's slice of the stacked expert weights is used in place.

Left for later work: ``wgmma`` and TMA for the prefill regime, and skipping
experts that received no token (that needs the per-expert counts as an
input, which the Pallas kernel does not take).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import grouped_matmul_ref

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "ham_grouped_matmul": [_P] * 3 + [_I] * 5 + [_L] * 6 + [_I, _P],
}

#: kernel launches made by :func:`grouped_matmul` (plain calls not counted)
launches = 0


def grouped_matmul_plain(x, w):
    """The plain PyTorch version, same signature as :func:`grouped_matmul`."""
    return grouped_matmul_ref(x, w)


def grouped_matmul(x, w):
    """x: (E, C, d); w: (E, d, f), any strides with a unit last dim ->
    (E, C, f) in x's dtype, accumulated in float32.

    CPU tensors take the plain version; CUDA tensors launch the kernel.
    """
    if x.device.type == "cpu":
        return grouped_matmul_plain(x, w)
    return _launch(x, w)


def _launch(x, w):
    global launches
    dtype = _build.check_inputs("grouped_matmul", (x, w))
    E, C, d = x.shape
    f = w.shape[-1]
    if w.shape != (E, d, f):
        raise ValueError(f"grouped_matmul shapes x {tuple(x.shape)} w {tuple(w.shape)}")
    out = torch.empty((E, C, f), dtype=x.dtype, device=x.device)
    lib = _build.library("grouped_matmul", _SIGNATURES)
    err = lib.ham_grouped_matmul(
        x.data_ptr(), w.data_ptr(), out.data_ptr(), E, C, d, f, dtype,
        *x.stride()[:2], *w.stride()[:2], *out.stride()[:2],
        x.device.index, torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(lib, err, "grouped_matmul")
    launches += 1
    return out
