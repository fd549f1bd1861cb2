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
What the design does about it (:func:`route` picks the kernel):

* bf16 prefill (C > 8) takes ``wgmma``: TMA loads into a 4-stage ring fed
  by one producer warpgroup, two consumer warpgroups multiplying with
  ``wgmma``, a persistent grid walking (256-row chunk of C, expert, 128
  columns of f) tiles so each w tile leaves device memory once per call;
* bf16 decode (C <= 8) takes ``stream``: one block per (256-column slab of
  f, expert), a producer warp streaming w through an 8-stage ring of TMA
  boxes, four warps multiplying w^T x^T on the tensor cores and adding
  their sums in warp order;
* float32 takes ``skinny`` (C <= 8) or ``tiled`` on the CUDA cores (TF32
  would miss the float32 tolerance).  Nothing routes to the plain version.

Every view the wrapper accepts (16-byte aligned base and outer strides:
``_build.check_inputs``) is one TMA can read; a ragged d or f reads as
zeros past the edge.  All kernels read x and w through strides, so a
layer's slice of the stacked expert weights is used in place.  Left for
later work: skipping experts that received no token (that needs the
per-expert counts as an input, which the Pallas kernel does not take).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import grouped_matmul_ref

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "ham_grouped_matmul": [_P] * 3 + [_I] * 7 + [_L] * 6 + [_I, _P],
}
#: route codes of the C interface (csrc/grouped_matmul.cu ``Route``)
ROUTES = {"skinny": 0, "tiled": 1, "stream": 2, "wgmma": 3}
SKINNY_ROWS = 8        # C at or below which a call is a decode (csrc kRows)
WGMMA_N = 128          # f columns of a wgmma tile (csrc kWN)
WGMMA_M = 256          # rows of C a wgmma tile covers (csrc kWSlabs x 64)

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


def route(x, w) -> str:
    """The kernel a call takes: ``stream`` (decode) or ``wgmma`` (prefill)
    for bf16, ``skinny`` (decode) or ``tiled`` (prefill) for float32."""
    decode = x.shape[1] <= SKINNY_ROWS
    if x.dtype == torch.bfloat16:
        return "stream" if decode else "wgmma"
    return "skinny" if decode else "tiled"


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _launch(x, w):
    """Launch the kernel of :func:`route`."""
    global launches
    dtype = _build.check_inputs("grouped_matmul", (x, w))
    E, C, d = x.shape
    f = w.shape[-1]
    if w.shape != (E, d, f):
        raise ValueError(f"grouped_matmul shapes x {tuple(x.shape)} w {tuple(w.shape)}")
    out = torch.empty((E, C, f), dtype=x.dtype, device=x.device)
    r = route(x, w)
    grid = 0
    if r == "wgmma":   # one persistent block per SM, or per tile if fewer
        grid = min(-(-C // WGMMA_M) * E * -(-f // WGMMA_N), _sm_count(x.device.index))
    lib = _build.library("grouped_matmul", _SIGNATURES)
    err = lib.ham_grouped_matmul(
        x.data_ptr(), w.data_ptr(), out.data_ptr(), E, C, d, f, dtype, ROUTES[r], grid,
        *x.stride()[:2], *w.stride()[:2], *out.stride()[:2],
        x.device.index, torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(lib, err, f"grouped_matmul ({r})")
    launches += 1
    return out
