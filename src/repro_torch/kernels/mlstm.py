"""Chunkwise-parallel mLSTM: a CUDA kernel written by hand for Hopper
(``csrc/mlstm.cu``) beside its plain version.

Replaces the Pallas TPU kernel ``repro/kernels/mlstm.py`` (``_mlstm_kernel``
and its wrapper ``mlstm_chunked_kernel``): per (sequence, head), chunks of
L positions run in order carrying the float32 state C (dk x dv), n (dk) and
m; inside a chunk the output is two products (decay-weighted q.k scores
times v, and q times the carried C) over a max-stabilised denominator.

What bounds it on an H100: operations.  An xlstm-1.3b admission of 1024
tokens (4 heads, dk 512, dv 1024, L 256) needs 10.2 GFLOP (the score
products on and below the diagonal) on ~34 MB.  The TPU kernel keeps C, 2 MB at these widths,
in VMEM across the whole chunk loop, one grid row per (sequence, head); a
block here has 227 KB of shared memory, and B*H = 4 rows would fill 4 of
132 SMs.  What the design does about it:

* a scalar prologue per (sequence, head) computes every gate quantity (the
  log-forget cumsum, the running max, the m chain across chunks) once;
* bf16 inputs at xLSTM widths (:func:`route`) take the tensor cores: a
  state pass gives each 128 x 128 tile of C a block that forms every
  chunk's update k^T (e^{a-g_L} v) with ``mma.sync`` and combines the
  chunks in order in float32, storing the state at each chunk start as the
  bf16 operand of the next pass; a fused pass then forms, per (chunk, 64
  positions, 256 dv columns), q C_prev, the decay-weighted causal scores and
  P V flash-style, with no score tile in device memory.  The decay-weighted
  v enters its product as a bf16 hi + lo pair: one rounding of it misses the
  state tolerance at dk 512;
* float32 inputs keep the CUDA-core passes of the first port (a state pass
  per 64 x 64 tile of C, a score pass and an output pass), exact to the
  float32 tolerance;
* any S is taken: the positions past S in the last chunk are masked, so
  the model calls it with ``chunk = min(chunk_size, S)`` and a prime prompt
  length never degenerates to chunk 1.

Numerics: q is divided by sqrt(dk) and rounded to its dtype before the
products, as the model's chunked form (the plain version) does (the
tensor-core route multiplies by the reciprocal, which can differ from the
division by one float ulp before the rounding); the TPU kernel scales after
the upcast.  The carried state and every accumulator are float32.

The plain version keeps the reference's chunk rule: the chunk shrinks
until it divides S.

Under autograd (grad enabled and an input that requires grad) a CUDA call
with no initial state goes through :class:`_MLSTM`, whose backward launches
``csrc/mlstm_bwd.cu`` (the states at chunk starts recomputed in float32,
the stabilisers held constant, the chunks walked in reverse carrying d[C |
n]; gate passes a warp per chunk; bf16 on the tensor cores with no P or
dS tile in device memory (:func:`backward_route`), float32 on the CUDA
cores; no atomics, so a step's gradients repeat bit for bit; see the
source's note).  The backward covers the gradient of h: a call under grad
with an initial state, or whose loss reaches the final state, raises
(ROADMAP Queue 1 item 12f).  Otherwise a call launches the forward exactly
as before, so serving's launches and times do not move.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import divisor_chunk, mlstm_chunk_ref

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "ham_mlstm_chunked": [_P] * 17 + [_I] * 9 + [_L] * 18 + [_I, _P],
}
_BWD_SIGNATURES = {
    "ham_mlstm_bwd_workspace": [_I] * 8 + [_P, _P],
    "ham_mlstm_bwd": [_P] * 12 + [_I] * 8 + [_P, _I, _P],
}
_TILE = 64  # csrc/mlstm.cu kT: the chunk is padded to a multiple of it
_TC_DK, _TC_DV = 256, 256  # csrc/mlstm.cu kScoreK, kDvT: the tensor-core route's tiles
_TC_MAX_DK = 512            # csrc/mlstm.cu kTcMaxDk: a block's q rows sit in shared memory
_TC_BWD_MAX_L = 1536        # csrc/mlstm_bwd.cu kTcMaxLp: a 64 x L tile of P or dS in shared memory

#: kernel launches made by :func:`mlstm_chunked_heads` (plain calls not counted)
launches = 0
#: backward launches (:func:`mlstm_chunked_heads_backward`), one per gradient
launches_backward = 0


def mlstm_chunked_heads_plain(q, k, v, i_pre, f_pre, state=None, *, chunk):
    """The plain PyTorch version of :func:`mlstm_chunked_heads`."""
    t = lambda a: a.transpose(1, 2)   # (B, H, S, ...) -> the model's (B, S, H, ...)
    h, st = mlstm_chunk_ref(t(q), t(k), t(v), t(i_pre), t(f_pre), state,
                            chunk=divisor_chunk(chunk, q.shape[2]))
    return t(h), st


def mlstm_chunked_heads_backward_plain(q, k, v, i_pre, f_pre, dh, *, chunk):
    """The plain version of :func:`mlstm_chunked_heads_backward`: autograd
    through :func:`mlstm_chunked_heads_plain` with no initial state."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v, i_pre, f_pre)]
        h, _ = mlstm_chunked_heads_plain(*leaves, chunk=chunk)
        return torch.autograd.grad(h, leaves, dh)


def mlstm_chunked_heads_backward(q, k, v, i_pre, f_pre, dh, *, chunk):
    """(dq, dk, dv, di, df) of :func:`mlstm_chunked_heads` at (q, k, v,
    i_pre, f_pre) with no initial state, for the gradient ``dh`` of h; each
    in its input's dtype, q/k/v's in the model's (B, S, H, d) layout and the
    gates' in (B, S, H) (returned as (B, H, S, ...) views).  CPU tensors
    take the plain version; CUDA tensors launch the backward kernel."""
    if q.device.type == "cpu":
        return mlstm_chunked_heads_backward_plain(q, k, v, i_pre, f_pre, dh, chunk=chunk)
    return _launch_backward(q, k, v, i_pre, f_pre, dh, chunk)


class _MLSTM(torch.autograd.Function):
    """The forward kernel with no initial state, the backward kernel as its
    gradient.  Outputs h and the final (C, n, m); the final state's gradient
    is not taken (item 12f): a loss that reaches it raises."""

    @staticmethod
    def forward(ctx, q, k, v, i_pre, f_pre, chunk):
        ctx.set_materialize_grads(False)
        B, H, S, _ = q.shape
        out = torch.empty((B, S, H, v.shape[-1]), dtype=v.dtype, device=v.device)
        h, (C, n, m) = _launch(q, k, v, i_pre, f_pre, None, chunk, out.transpose(1, 2))
        ctx.save_for_backward(q, k, v, i_pre, f_pre)
        ctx.chunk = chunk
        return h, C, n, m

    @staticmethod
    def backward(ctx, dh, dC, dn, dm):
        if dC is not None or dn is not None or dm is not None:
            raise NotImplementedError(
                "mlstm: the gradient of the final state has no kernel on the card yet "
                "(ROADMAP Queue 1 item 12f); only h's gradient is taken")
        if dh is None:
            return (None,) * 6
        return (*_launch_backward(*ctx.saved_tensors, dh, ctx.chunk), None)


def mlstm_chunked_plain(q, k, v, i_pre, f_pre, state=None, *, chunk=256):
    """The plain PyTorch version, in the kernel layout of
    :func:`mlstm_chunked`."""
    st = None if state is None else tuple(s[None] for s in state)
    h, (C, n, m) = mlstm_chunked_heads_plain(q[None], k[None], v[None], i_pre[None],
                                             f_pre[None], st, chunk=chunk)
    return h[0], (C[0], n[0], m[0])


def mlstm_chunked(q, k, v, i_pre, f_pre, state=None, *, chunk=256):
    """The reference's signature: q, k (BH, S, dk); v (BH, S, dv); gates
    (BH, S); state (C (BH,dk,dv), n (BH,dk), m (BH,)).  Returns (h (BH, S,
    dv), (C, n, m))."""
    st = None if state is None else tuple(s[None] for s in state)
    h, (C, n, m) = mlstm_chunked_heads(q[None], k[None], v[None], i_pre[None],
                                       f_pre[None], st, chunk=chunk)
    return h[0], (C[0], n[0], m[0])


def mlstm_chunked_heads(q, k, v, i_pre, f_pre, state=None, *, chunk, out=None):
    """q, k: (B, H, S, dk); v: (B, H, S, dv); gates (B, H, S), any strides
    (a unit last dim for q/k/v); state (C (B,H,dk,dv), n (B,H,dk), m (B,H))
    float32, or None for the empty state.  Returns (h (B, H, S, dv) in v's
    dtype, written into ``out`` if given, (C, n, m) float32).

    CPU tensors take the plain version (chunk shrunk to divide S); CUDA
    tensors launch the kernel with chunk ``min(chunk, S)`` and a masked
    ragged tail; under autograd they go through :class:`_MLSTM` (no
    ``state``, no ``out``: writing into ``out`` would cut the graph).
    """
    if q.device.type == "cpu":
        h, st = mlstm_chunked_heads_plain(q, k, v, i_pre, f_pre, state, chunk=chunk)
        return (h if out is None else out.copy_(h)), st
    if _build.grad_wanted(q, k, v, i_pre, f_pre, *(state or ())):
        if state is not None:
            raise NotImplementedError(
                "mlstm under autograd takes no initial state on the card yet (ROADMAP "
                "Queue 1 item 12f); call it under torch.no_grad() or on CPU tensors")
        if out is not None:
            raise ValueError("mlstm under autograd returns a new h; out= would cut the graph")
        h, C, n, m = _MLSTM.apply(q, k, v, i_pre, f_pre, chunk)
        return h, (C, n, m)
    return _launch(q, k, v, i_pre, f_pre, state, chunk, out)


def route(q, v) -> str:
    """``tensor_cores`` for bf16 inputs whose widths fill the tensor-core
    tiles (dk 256 or 512, dv a multiple of 256: xlstm-1.3b's 512 and 1024);
    ``cuda_cores`` otherwise (float32 keeps its exact products)."""
    dk, dv = q.shape[-1], v.shape[-1]
    if (q.dtype == torch.bfloat16 and dk % _TC_DK == 0 and dk <= _TC_MAX_DK
            and dv % _TC_DV == 0):
        return "tensor_cores"
    return "cuda_cores"


def backward_route(q, v, chunk) -> str:
    """The backward kernel's route: ``tensor_cores`` for bf16 with dk and dv
    multiples of 8 and a chunk of at most ``_TC_BWD_MAX_L`` positions
    (rounded up to the 64-wide tile), ``cuda_cores`` otherwise."""
    dk, dv, S = q.shape[-1], v.shape[-1], q.shape[-2]
    Lp = -(-min(chunk, S) // _TILE) * _TILE
    if q.dtype == torch.bfloat16 and dk % 8 == 0 and dv % 8 == 0 and Lp <= _TC_BWD_MAX_L:
        return "tensor_cores"
    return "cuda_cores"


@_build.counted
def _launch(q, k, v, i_pre, f_pre, state, chunk, out, kernel=None):
    """Launch the kernel; ``kernel`` overrides the route (for timing each)."""
    B, H, S, dk = q.shape
    dv = v.shape[-1]
    if out is None:
        out = torch.empty((B, H, S, dv), dtype=v.dtype, device=v.device)
    dtype = _build.check_inputs("mlstm", (q, k, v, out))
    if (k.shape != q.shape or v.shape != (B, H, S, dv) or out.shape != v.shape
            or i_pre.shape != (B, H, S) or f_pre.shape != (B, H, S)):
        raise ValueError(f"mlstm shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} gates {tuple(i_pre.shape)}")
    # the kernel reads the gates as scalars through strides
    _build.check_aux("mlstm", q, (i_pre, f_pre), q.dtype, "gates")
    if chunk < 1:
        raise ValueError(f"mlstm chunk must be positive, got {chunk}")
    L = min(chunk, S)
    nc, Lp = -(-S // L), -(-L // _TILE) * _TILE
    f32 = dict(dtype=torch.float32, device=q.device)
    C, n, m = (torch.empty((B, H, dk, dv), **f32), torch.empty((B, H, dk), **f32),
               torch.empty((B, H), **f32))
    if state is not None:
        _build.check_aux("mlstm", q, state, torch.float32, "state")
        if (tuple(state[0].shape), tuple(state[1].shape), tuple(state[2].shape)) != (
                (B, H, dk, dv), (B, H, dk), (B, H)) or not all(s.is_contiguous() for s in state):
            raise ValueError("mlstm state must be contiguous (C (B,H,dk,dv), n (B,H,dk), m (B,H))")
    st0 = state if state is not None else (C, n, m)   # not read without a state
    BH = B * H
    tc = (kernel or route(q, v)) == "tensor_cores"
    # gates, per-chunk scalars, P^T tiles (CUDA-core route only), the state
    # at every chunk start (bf16 on the tensor-core route: the operand the
    # fused pass multiplies q by), n at every chunk start
    ws = [torch.empty(4 * BH * nc * Lp, **f32), torch.empty(BH * (2 * nc + 1), **f32),
          torch.empty(0 if tc else BH * nc * Lp * Lp, **f32),
          torch.empty(BH * nc * dk * dv, dtype=torch.bfloat16 if tc else torch.float32,
                      device=q.device),
          torch.empty(BH * nc * dk, **f32)]
    lib = _build.library("mlstm", _SIGNATURES)
    err = lib.ham_mlstm_chunked(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), i_pre.data_ptr(), f_pre.data_ptr(),
        *(s.data_ptr() for s in st0), out.data_ptr(), C.data_ptr(), n.data_ptr(), m.data_ptr(),
        *(w.data_ptr() for w in ws),
        B, H, S, dk, dv, L, int(state is not None), dtype, int(tc),
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        *i_pre.stride(), *f_pre.stride(),
        q.device.index, torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(lib, err, "mlstm")
    return out, (C, n, m)


def _launch_backward(q, k, v, i_pre, f_pre, dh, chunk, kernel=None):
    """Launch the backward kernel: (dq, dk, dv) in the model's (B, S, H, d)
    layout and (di, df) in (B, S, H), returned as (B, H, S, ...) views; one
    float32 scratch buffer (csrc/mlstm_bwd.cu's layout).  ``kernel``
    "cuda_cores" keeps bf16 on the CUDA-core route (for timing it)."""
    B, H, S, dk = q.shape
    dv = v.shape[-1]
    if dh.stride(-1) != 1 or not _build._aligned(dh):
        dh = dh.contiguous()
    heads = lambda t: torch.empty((B, S, H, t.shape[-1]), dtype=t.dtype,
                                  device=t.device).transpose(1, 2)
    dq, dk_, dv_ = heads(q), heads(k), heads(v)
    di, df = (torch.empty((B, S, H), dtype=t.dtype, device=t.device).transpose(1, 2)
              for t in (i_pre, f_pre))
    dtype = _build.check_inputs("mlstm backward", (q, k, v, dh, dq, dk_, dv_))
    _build.check_aux("mlstm backward", q, (i_pre, f_pre), q.dtype, "gates")
    if (k.shape != q.shape or v.shape != (B, H, S, dv) or dh.shape != v.shape
            or i_pre.shape != (B, H, S) or f_pre.shape != (B, H, S)):
        raise ValueError(f"mlstm backward shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} dh {tuple(dh.shape)} gates {tuple(i_pre.shape)}")
    if chunk < 1:
        raise ValueError(f"mlstm chunk must be positive, got {chunk}")
    L = min(chunk, S)
    lib = _build.library("mlstm_bwd", _BWD_SIGNATURES)
    allow_tc = int(kernel != "cuda_cores")
    nbytes, tc = ctypes.c_longlong(), ctypes.c_int()
    _build.check(lib, lib.ham_mlstm_bwd_workspace(B, H, S, dk, dv, L, dtype, allow_tc,
                                                  ctypes.byref(nbytes), ctypes.byref(tc)),
                 "mlstm backward")
    if bool(tc.value) != (allow_tc and backward_route(q, v, chunk) == "tensor_cores"):
        raise RuntimeError("mlstm backward: the kernel's route disagrees with backward_route")
    work = torch.empty(nbytes.value, dtype=torch.uint8, device=q.device)
    tensors = (q, k, v, i_pre, f_pre, dh, dq, dk_, dv_, di, df)
    strides = (ctypes.c_longlong * 33)(*(s for t in tensors for s in t.stride()[:3]))
    err = lib.ham_mlstm_bwd(
        *(t.data_ptr() for t in tensors), work.data_ptr(), B, H, S, dk, dv, L, dtype, allow_tc,
        ctypes.addressof(strides), q.device.index,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(lib, err, "mlstm backward")
    _build.count(__name__, "launches_backward")
    return dq, dk_, dv_, di, df
