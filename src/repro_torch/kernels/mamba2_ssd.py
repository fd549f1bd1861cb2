"""Mamba2 SSD (state-space dual) chunked scan: a CUDA kernel written by hand
for Hopper (``csrc/mamba2_ssd.cu``) beside its plain version.

Replaces the Pallas TPU kernel ``repro/kernels/mamba2_ssd.py``
(``_ssd_kernel`` and its wrapper ``ssd_chunked_kernel``): per (sequence,
head), chunks of L positions run in order carrying the float32 state h
(N x P); inside a chunk, with Lc the inclusive cumsum of log lambda = A dt,
the output is the decay-weighted causal (C.B^T) tile times x plus
exp(Lc) C h_prev, and h takes the chunk's decayed B x^T outer products.

What bounds it on an H100: a zamba2-2.7b admission of 1024 tokens (80
heads, P = N = 64, one B/C group, L = 256) moves 22.9 MB, 6.8 us at the
card's memory rate; its 4.0 GFLOP on and below the diagonal take 4.1 us at
the bf16 peak.  The TPU kernel walks one (sequence, head)'s chunks in
order; on the card that walk gives 80 blocks for 132 SMs.  What the design
does about it:

* bf16 inputs (:func:`route`) take the tensor cores and split the chunks
  across blocks, in three passes on the stream: each chunk's state update
  dh = (B w)^T x, w_s = e^{Lc_L - Lc_s} dt_s, one block per (chunk, head,
  sequence), the weighted B rounded once to bf16; an in-order combine
  h = e^{Lc_L} h + dh in float32 that stores h at every chunk start as
  bf16, one block per (quarter of h, head, sequence); and the outputs, one
  block per (64-position tile, chunk, head, sequence), heaviest first,
  forming e^{Lc_t} C h_prev and the decay-weighted causal (C B^T) tile
  times x flash-style (no score tile in memory), B and x streaming through
  a cp.async ring;
* float32 inputs keep the first port's CUDA-core kernel: one block per
  (head, sequence) walking the chunks with h in shared memory, every
  product in float32;
* on either route the L x L product runs in 64 x 64 tiles on and below
  the diagonal only, so the decay exponent is never evaluated where it is
  positive (the reference masks after ``exp``, which in CUDA would turn an
  overflow into inf * 0 = NaN);
* x, B and C are read through strides from the model's conv output, the
  group of head h being ``h // (H // G)``: the reference wrapper's head
  repeat of B and C (an 80x copy at one group) and its transposes are never
  made, and y is written in the model's ``(B, S, H, P)`` layout;
* A dt is formed in the kernel, and the D x skip is fused into the
  epilogue with y rounded once, as the reference model's plain
  ``ssd_chunked`` does (its kernel wrapper rounds y, then adds D x);
* any S is taken: positions past S in the last chunk read x = B = C = 0 and
  dt = 0 (log decay 0, weight 0), which leaves y and h exact, so the model
  calls it with ``chunk = min(chunk_size, S)`` and a prime prompt length
  never degenerates to chunk 1.

The plain version keeps the reference's chunk rule: the chunk shrinks
until it divides S.

Under autograd (grad enabled and an input that requires grad) a CUDA call
with no initial state goes through :class:`_SSD`, whose backward launches
``csrc/mamba2_ssd_bwd.cu``.  Its gate passes run a warp per (sequence,
head, chunk) on both routes; bf16 at N = P = 64 and chunk <= 256
(:func:`backward_route`) takes the tensor cores: h and dh walked on
``mma.sync``, then a row pass and a column pass per 64-position tile that
recompute M and dCB per tile in shared memory (never stored) and sum dB
and dC over blocks of each group's heads; float32 keeps the CUDA-core
passes (h at chunk starts recomputed in float32, M and dCB stored per
head).  No atomics on either route; see the source's note.  The backward
covers the gradient of y: a call under grad with an initial state, or
whose loss reaches the final state, raises (ROADMAP Queue 1 item 12f).
Otherwise a call launches the forward exactly as before, so serving's
launches and times do not move.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import divisor_chunk, ssd_chunk_ref

STATE_DIM = 64   # N
HEAD_DIM = 64    # P
MAX_CHUNK = 256  # csrc/mamba2_ssd.cu kMaxL: one position per thread in the scan
#: csrc/mamba2_ssd_bwd.cu kTcMaxL: the backward's tensor-core route takes
#: chunks up to this (a row of C B^T tiles in shared memory)
TC_BWD_MAX_CHUNK = 256
_TILE = 64       # csrc/mamba2_ssd.cu kT: the chunk is padded to a multiple of it
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "ham_ssd_chunked": [_P] * 14 + [_I] * 10 + [_L] * 15 + [_I, _P],
}
_BWD_SIGNATURES = {
    "ham_ssd_bwd_workspace": [_I] * 10 + [_P],
    "ham_ssd_bwd": [_P] * 14 + [_I] * 10 + [_P, _I, _P],
}

#: kernel launches made by :func:`ssd_chunked` (plain calls not counted)
launches = 0
#: backward launches (:func:`ssd_chunked_backward`), one per gradient
launches_backward = 0


def ssd_chunked_plain(x, dt, A, Bm, Cm, D, state=None, *, chunk=256):
    """The plain PyTorch version of :func:`ssd_chunked`: the port's
    ``models.mamba2.ssd_chunked`` with the chunk shrunk to divide S."""
    return ssd_chunk_ref(x, dt, A, Bm, Cm, D, state, chunk=divisor_chunk(chunk, x.shape[1]))


def ssd_chunked_backward_plain(x, dt, A, Bm, Cm, D, dy, *, chunk=256):
    """The plain version of :func:`ssd_chunked_backward`: autograd through
    :func:`ssd_chunked_plain` with no initial state."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in (x, dt, A, Bm, Cm, D)]
        y, _ = ssd_chunked_plain(*leaves, chunk=chunk)
        return torch.autograd.grad(y, leaves, dy)


def ssd_chunked_backward(x, dt, A, Bm, Cm, D, dy, *, chunk=256):
    """(dx, ddt, dA, dBm, dCm, dD) of :func:`ssd_chunked` at (x, dt, A, Bm,
    Cm, D) with no initial state, for the gradient ``dy`` of y; each in its
    input's dtype and shape.  CPU tensors take the plain version; CUDA
    tensors launch the backward kernel."""
    if _build.takes_plain(x):
        return ssd_chunked_backward_plain(x, dt, A, Bm, Cm, D, dy, chunk=chunk)
    return _launch_backward(x, dt, A, Bm, Cm, D, dy, chunk)


class _SSD(torch.autograd.Function):
    """The forward kernel with no initial state, the backward kernel as its
    gradient.  Outputs y and the final h; the final state's gradient is not
    taken (item 12f): a loss that reaches it raises."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, D, chunk):
        ctx.set_materialize_grads(False)
        y, h = _launch(x, dt, A, Bm, Cm, D, None, chunk)
        ctx.save_for_backward(x, dt, A, Bm, Cm, D)
        ctx.chunk = chunk
        return y, h

    @staticmethod
    def backward(ctx, dy, dh):
        if dh is not None:
            raise NotImplementedError(
                "ssd: the gradient of the final state has no kernel on the card yet "
                "(ROADMAP Queue 1 item 12f); only y's gradient is taken")
        if dy is None:
            return (None,) * 7
        return (*_launch_backward(*ctx.saved_tensors, dy, ctx.chunk), None)


def ssd_chunked(x, dt, A, Bm, Cm, D, state=None, *, chunk=256):
    """Model layout: x (B, S, H, P); dt (B, S, H) float32; A, D (H,)
    float32; Bm, Cm (B, S, G, N) with H % G == 0, x/Bm/Cm any strides with
    a unit last dim; state h (B, H, N, P) float32 or None for the empty
    state.  Returns (y (B, S, H, P) in x's dtype with the D x skip added,
    final h float32).

    CPU tensors take the plain version (chunk shrunk to divide S); CUDA
    tensors launch the kernel with chunk ``min(chunk, S)`` and a masked
    ragged tail; under autograd they go through :class:`_SSD` (no
    ``state``).
    """
    if _build.takes_plain(x):
        return ssd_chunked_plain(x, dt, A, Bm, Cm, D, state, chunk=chunk)
    if _build.grad_wanted(x, dt, A, Bm, Cm, D, state):
        if state is not None:
            raise NotImplementedError(
                "ssd under autograd takes no initial state on the card yet (ROADMAP Queue 1 "
                "item 12f); call it under torch.no_grad() or on CPU tensors")
        return _SSD.apply(x, dt, A, Bm, Cm, D, chunk)
    return _launch(x, dt, A, Bm, Cm, D, state, chunk)


def route(x) -> str:
    """``tensor_cores`` for bf16 inputs, ``cuda_cores`` for float32 (whose
    products stay in float32, exact to the float32 tolerance).  Every view
    the wrapper accepts (16-byte aligned base and outer strides,
    ``_build.check_inputs``) is one the tensor-core route's 16-byte
    ``cp.async`` copies read, so the route depends on the dtype alone."""
    return "tensor_cores" if x.dtype == torch.bfloat16 else "cuda_cores"


@_build.counted
def _launch(x, dt, A, Bm, Cm, D, state, chunk, kernel=None):
    """Launch the kernel; ``kernel`` overrides the route (for timing the
    CUDA-core route on bf16 inputs)."""
    B, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    y = torch.empty((B, S, H, P), dtype=x.dtype, device=x.device)
    dtype = _build.check_inputs("ssd", (x, Bm, Cm, y))
    if (Bm.shape != (B, S, G, N) or Cm.shape != Bm.shape or dt.shape != (B, S, H)
            or A.shape != (H,) or D.shape != (H,) or H % G):
        raise ValueError(f"ssd shapes x {tuple(x.shape)} dt {tuple(dt.shape)} A {tuple(A.shape)} "
                         f"B {tuple(Bm.shape)} C {tuple(Cm.shape)} D {tuple(D.shape)}")
    if (N, P) != (STATE_DIM, HEAD_DIM):
        raise ValueError(f"ssd kernel takes state_dim {STATE_DIM} and head_dim {HEAD_DIM}, "
                         f"got {N}, {P}")
    # dt is read as scalars through strides; A and D as (H,) vectors
    _build.check_aux("ssd", x, (dt, A, D), torch.float32, "dt, A and D")
    if not (A.is_contiguous() and D.is_contiguous()):
        raise ValueError("ssd A and D must be contiguous")
    if chunk < 1:
        raise ValueError(f"ssd chunk must be positive, got {chunk}")
    L = min(chunk, S)
    if L > MAX_CHUNK:
        raise ValueError(f"ssd kernel takes chunks of at most {MAX_CHUNK}, got {L}")
    hN = torch.empty((B, H, N, P), dtype=torch.float32, device=x.device)
    if state is not None:
        _build.check_aux("ssd", x, (state,), torch.float32, "state")
        if tuple(state.shape) != (B, H, N, P) or not state.is_contiguous():
            raise ValueError(f"ssd state must be contiguous (B, H, N, P) = {(B, H, N, P)}, "
                             f"got {tuple(state.shape)}")
    h0 = state if state is not None else hN   # not read without a state
    tc = (kernel or route(x)) == "tensor_cores"
    # work holds the scratch until the launches are queued on the stream
    work, ws = _scratch(B * H * -(-S // L), -(-L // _TILE) * _TILE, x.device) if tc else (
        None, [None] * 5)
    lib = _build.library("mamba2_ssd", _SIGNATURES)
    err = lib.ham_ssd_chunked(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), D.data_ptr(),
        h0.data_ptr(), y.data_ptr(), hN.data_ptr(), *ws,
        B, S, H, G, N, P, L, int(state is not None), dtype, int(tc),
        *x.stride()[:3], *dt.stride(), *Bm.stride()[:3], *Cm.stride()[:3], *y.stride()[:3],
        x.device.index, torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(lib, err, "ssd")
    return y, hN


def _scratch(chunks, Lp, device):
    """The tensor-core route's scratch as one allocation for ``chunks``
    (sequence, head, chunk) triples of Lp padded positions: (the buffer,
    the pointers of its parts) -- Lc, dt and the tile-local weight (float32,
    Lp a chunk each), each chunk's dh (float32, N x P) and h at each chunk
    start (bf16, N x P).  Every part's size is a multiple of 256 bytes, so
    each part starts aligned."""
    sizes = [4 * chunks * Lp] * 3 + [4 * chunks * STATE_DIM * HEAD_DIM,
                                     2 * chunks * STATE_DIM * HEAD_DIM]
    buf = torch.empty(sum(sizes), dtype=torch.uint8, device=device)
    ptrs, at = [], buf.data_ptr()
    for n in sizes:
        ptrs.append(at)
        at += n
    return buf, ptrs


def backward_route(x, Bm, chunk) -> str:
    """The backward's route: ``tensor_cores`` for bf16 at N = P = 64 and
    a chunk of at most :data:`TC_BWD_MAX_CHUNK` (``mma.sync`` tiles of 64),
    else ``cuda_cores``."""
    ok = (x.dtype == torch.bfloat16 and x.shape[-1] == HEAD_DIM
          and Bm.shape[-1] == STATE_DIM and min(chunk, x.shape[1]) <= TC_BWD_MAX_CHUNK)
    return "tensor_cores" if ok else "cuda_cores"


def backward_workspace(x, Bm, chunk, kernel=None) -> int:
    """Bytes of scratch the backward takes on ``kernel`` (default: its
    route) for these shapes."""
    B, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    tc = (kernel or backward_route(x, Bm, chunk)) == "tensor_cores"
    lib = _build.library("mamba2_ssd_bwd", _BWD_SIGNATURES)
    nbytes = ctypes.c_longlong()
    _build.check(lib, lib.ham_ssd_bwd_workspace(
        B, S, H, G, N, P, min(chunk, S), _build.DTYPE_CODES[x.dtype], int(tc),
        _build.sm_count(x.device.index), ctypes.byref(nbytes)), "ssd backward")
    return nbytes.value


def _launch_backward(x, dt, A, Bm, Cm, D, dy, chunk, kernel=None):
    """Launch the backward kernel: (dx, ddt, dA, dBm, dCm, dD), new
    contiguous tensors; one scratch buffer (csrc/mamba2_ssd_bwd.cu's
    layout).  ``kernel="cuda_cores"`` overrides :func:`backward_route`
    (for timing the CUDA-core route on bf16 inputs)."""
    B, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    if dy.stride(-1) != 1 or not _build._aligned(dy):
        dy = dy.contiguous()
    dx = torch.empty((B, S, H, P), dtype=x.dtype, device=x.device)
    dBm, dCm = (torch.empty((B, S, G, N), dtype=Bm.dtype, device=x.device) for _ in range(2))
    f32 = dict(dtype=torch.float32, device=x.device)
    ddt, dA, dD = torch.empty((B, S, H), **f32), torch.empty(H, **f32), torch.empty(H, **f32)
    dtype = _build.check_inputs("ssd backward", (x, Bm, Cm, dy, dx, dBm, dCm))
    _build.check_aux("ssd backward", x, (dt, A, D), torch.float32, "dt, A and D")
    if (Bm.shape != (B, S, G, N) or Cm.shape != Bm.shape or dt.shape != (B, S, H)
            or A.shape != (H,) or D.shape != (H,) or H % G or dy.shape != x.shape):
        raise ValueError(f"ssd backward shapes x {tuple(x.shape)} dt {tuple(dt.shape)} "
                         f"B {tuple(Bm.shape)} C {tuple(Cm.shape)} dy {tuple(dy.shape)}")
    if not (A.is_contiguous() and D.is_contiguous()):
        raise ValueError("ssd A and D must be contiguous")
    if chunk < 1:
        raise ValueError(f"ssd chunk must be positive, got {chunk}")
    tc = (kernel or backward_route(x, Bm, chunk)) == "tensor_cores"
    work = torch.empty(backward_workspace(x, Bm, chunk, kernel), dtype=torch.uint8,
                       device=x.device)
    lib = _build.library("mamba2_ssd_bwd", _BWD_SIGNATURES)
    strided = (x, Bm, Cm, dy, dt, dx, dBm, dCm, ddt)
    strides = (ctypes.c_longlong * 27)(*(s for t in strided for s in t.stride()[:3]))
    err = lib.ham_ssd_bwd(
        *(t.data_ptr() for t in (x, dt, A, Bm, Cm, D, dy, dx, ddt, dA, dBm, dCm, dD)),
        work.data_ptr(), B, S, H, G, N, P, min(chunk, S), dtype, int(tc),
        _build.sm_count(x.device.index), ctypes.addressof(strides),
        x.device.index, torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(lib, err, "ssd backward")
    _build.count(__name__, "launches_backward")
    return dx, ddt, dA, dBm, dCm, dD
