"""Flash attention (tiled online softmax, GQA-aware): CUDA kernels written by
hand for Hopper, the forward (``csrc/flash_attention.cu``) and its gradient
(``csrc/flash_attention_bwd.cu``), beside their plain versions.

Replaces the Pallas TPU kernel ``repro/kernels/flash_attention.py``
(``_flash_kernel`` and its wrapper ``flash_attention``).

What bounds it on an H100: operations.  A causal prefill of S=1024 over 48
heads of d=128 is about 12.9 GFLOP on 29 MB of q/k/v/o, far above the
card's 295 flops-per-byte line, so its bound is the tensor-core peak (about
13 us at 989 TFLOP/s).  What the design does about it, for bf16 (the
serving path), FlashAttention-2 style:

* one thread block per (batch*head, query tile), 16 query rows a warp (8
  warps and 128 rows at head_dim >= 80, 4 and 64 below); the q tile is
  loaded once into registers as tensor-core fragments;
* 64-key K and V tiles stay bf16 in a 3-stage ``cp.async`` ring in shared
  memory, the next tiles loading while the current one is multiplied;
* both products, S = q k^T and o += p v, run on the tensor cores
  (``mma.sync`` m16n8k16, float32 accumulators), and p goes from the score
  accumulators straight into the next product's operands;
* the loop over key tiles stops at the causal diagonal (the Pallas kernel
  skipped tiles above it with ``pl.when``), masks apply only on the diagonal
  and the ragged tail, and the query tiles with the most work are scheduled
  first;
* a causal sliding window (``window``, the reference model's
  ``causal_mask(window=)``; the Pallas kernel has none) starts each query
  tile's key loop at the tile holding its first row's oldest key, so the
  tiles left of the window are never loaded; the window's edge is masked
  inside its first tiles.  Bound: 4 d H per (query, key) pair in the
  window, sum_i min(i + 1, window) pairs a head;
* GQA reads kv head ``h // q_per_kv`` (the Pallas kernel's
  ``bh // q_per_kv``), so repeated K/V are never materialised;
* q/k/v/o are read and written through strides, so the model's
  ``(B, S, H, d)`` activations need no transpose copies.

float32 runs a CUDA-core kernel (float32 tiles in shared memory): the
tensor cores take float32 only as TF32, which would miss the float32
tolerance.  ``wgmma``, TMA and warp specialisation are later work.

Under autograd (grad enabled and an input that requires grad) a CUDA call
goes through :class:`_FlashAttention`: its forward asks the kernel for each
row's log-sum-exp as well (written from the online-softmax state, one
branch in the epilogue) and saves it, and its backward launches the
backward kernel (FlashAttention-2's: D = rowsum(dO o O); one block per key
tile accumulates dK and dV over its query tiles, for bf16 a block per q
head whose shares are summed over the kv group after; one block per query
tile forms dQ; for bf16 every product on the tensor cores; no atomics, so
a step's gradients repeat bit for bit; see the source's note).  Otherwise a call launches the forward with no LSE output,
so serving's launches and times do not move.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import attention_ref, attention_scores_ref

HEAD_DIMS = (32, 64, 80, 128, 192)
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "ham_flash_attention": [_P] * 4 + [_I] * 9 + [_L] * 12 + [_P, _I, _P],
}
_BWD_SIGNATURES = {
    "ham_flash_attention_bwd": [_P] * 11 + [_I] * 9 + [_P, _I, _P],
}

#: kernel launches made by :func:`flash_attention_heads` (plain calls not counted)
launches = 0
#: of those, the launches with a sliding window
launches_window = 0
#: backward launches (:func:`flash_attention_heads_backward`), one per gradient
launches_backward = 0


def flash_attention_heads_plain(q, k, v, *, causal=True, window=None):
    """The plain PyTorch version of :func:`flash_attention_heads`."""
    B, H, S, d = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    out = attention_ref(
        q.reshape(B * H, S, d), k.reshape(B * Hkv, Skv, d),
        v.reshape(B * Hkv, Skv, d), causal=causal, q_per_kv=H // Hkv, window=window,
    )
    return out.reshape(B, H, S, d)


def flash_attention_heads_lse_plain(q, k, v, *, causal=True, window=None):
    """The row log-sum-exp (natural log) of the scaled, masked scores, float32
    (B, H, S): what the forward kernel writes for its backward (``v`` is not
    needed)."""
    del v
    B, H, S, d = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    s = attention_scores_ref(q.reshape(B * H, S, d), k.reshape(B * Hkv, Skv, d), causal=causal,
                             q_per_kv=H // Hkv, window=window)
    return torch.logsumexp(s, dim=-1).reshape(B, H, S)


def flash_attention_heads_backward_plain(q, k, v, o, dout, *, causal=True, window=None):
    """The plain version of :func:`flash_attention_heads_backward`: autograd
    through :func:`flash_attention_heads_plain` (``o`` is not needed)."""
    del o
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        out = flash_attention_heads_plain(*leaves, causal=causal, window=window)
        return torch.autograd.grad(out, leaves, dout)


def flash_attention_heads_backward(q, k, v, o, dout, *, causal=True, window=None, lse=None):
    """(dq, dk, dv) of :func:`flash_attention_heads` at (q, k, v), whose
    output was ``o``, for the output gradient ``dout``; each in its input's
    dtype and the model's (B, S, heads, d) layout (returned as (B, heads,
    S, d) views).  ``lse``: the rows' log-sum-exp as the forward kernel
    saved it (float32 (B, H, S)); None launches the forward once more to
    write it (counted in ``launches``).  CPU tensors take the plain version
    (which needs no ``lse``); CUDA tensors launch the backward kernel."""
    if not causal:
        window = None
    if _build.takes_plain(q):
        return flash_attention_heads_backward_plain(q, k, v, o, dout, causal=causal,
                                                    window=window)
    if lse is None:
        lse = empty_lse(q)
        _launch(q, k, v, causal, window, lse)
    return _launch_backward(q, k, v, o, dout, causal, window, lse)


class _FlashAttention(torch.autograd.Function):
    """The forward kernel, saving each row's log-sum-exp, with the backward
    kernel as its gradient."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        lse = empty_lse(q)
        out = _launch(q, k, v, causal, window, lse)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _launch_backward(q, k, v, out, dout, ctx.causal, ctx.window, lse)
        return dq, dk, dv, None, None


def flash_attention_heads(q, k, v, *, causal=True, window=None):
    """q: (B, H, S, d); k/v: (B, Hkv, Skv, d) with H % Hkv == 0; any
    strides with a unit last dim.  Query head h reads kv head
    ``h // (H // Hkv)``; causal masks key j > query i, and a ``window``
    (causal only, as the reference's ``causal_mask``) also keys
    j <= i - window.  Returns (B, H, S, d), a view of a tensor in the
    model's (B, S, H, d) layout.

    CPU tensors take the plain version; CUDA tensors launch the kernel.
    """
    if window is not None and window < 1:
        raise ValueError(f"flash_attention window must be >= 1, got {window}")
    if not causal:
        window = None   # the reference applies a window only to causal masks
    if _build.takes_plain(q):
        return flash_attention_heads_plain(q, k, v, causal=causal, window=window)
    if _build.grad_wanted(q, k, v):
        return _FlashAttention.apply(q, k, v, causal, window)
    return _launch(q, k, v, causal, window)


def flash_attention(q, k, v, *, causal=True, q_per_kv=1):
    """The reference's signature: q (BH, S, d); k, v (BKV, Skv, d) with
    BH = BKV * q_per_kv (q row bh reads kv row bh // q_per_kv)."""
    if q.shape[0] != k.shape[0] * q_per_kv:
        raise ValueError(f"BH={q.shape[0]} != BKV={k.shape[0]} * q_per_kv={q_per_kv}")
    return flash_attention_heads(q[None], k[None], v[None], causal=causal)[0]


def empty_lse(q):
    """A float32 (B, H, S) tensor for the forward's row log-sum-exp."""
    return torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)


def empty_heads_like(t):
    """An empty (B, heads, S, d) tensor like ``t``, a view of one in the
    model's (B, S, heads, d) layout."""
    B, H, S, d = t.shape
    return torch.empty((B, S, H, d), dtype=t.dtype, device=t.device).transpose(1, 2)


@_build.counted
def _launch(q, k, v, causal, window, lse=None):
    """Launch the forward; with ``lse`` (float32 (B, H, S), contiguous) the
    kernel also writes each row's log-sum-exp there."""
    B, H, S, d = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    out = empty_heads_like(q)
    dtype = _build.check_inputs("flash_attention", (q, k, v, out))
    if k.shape != (B, Hkv, Skv, d) or v.shape != k.shape or H % Hkv:
        raise ValueError(f"flash_attention shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes head_dim in {HEAD_DIMS}, got {d}")
    if lse is not None:
        _check_lse(q, lse)
    lib = _build.library("flash_attention", _SIGNATURES)
    err = lib.ham_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, H, Hkv, S, Skv, d, int(causal), window or 0, dtype,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        None if lse is None else lse.data_ptr(),
        q.device.index, torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(lib, err, "flash_attention")
    if window:
        _build.count(__name__, "launches_window")
    return out


def _check_lse(q, lse):
    if (lse.dtype != torch.float32 or lse.device != q.device or lse.shape != q.shape[:3]
            or not lse.is_contiguous()):
        raise ValueError(f"flash_attention lse must be contiguous float32 {tuple(q.shape[:3])} "
                         f"on {q.device}, got {lse.dtype} {tuple(lse.shape)} on {lse.device}")


def _launch_backward(q, k, v, o, dout, causal, window, lse):
    """Launch the backward kernel: (dq, dk, dv) in the (B, S, heads, d)
    layout, returned as (B, heads, S, d) views, from the forward's row
    log-sum-exp ``lse``; float32 scratch for D and, for bf16 with H > Hkv,
    for the q heads' dK and dV shares."""
    B, H, S, d = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    if not _build._aligned(dout) or dout.stride(-1) != 1:
        dout = dout.contiguous()
    dq, dk, dv = (empty_heads_like(t) for t in (q, k, v))
    tensors = (q, k, v, o, dout, dq, dk, dv)
    dtype = _build.check_inputs("flash_attention backward", tensors)
    if k.shape != (B, Hkv, Skv, d) or v.shape != k.shape or H % Hkv or o.shape != q.shape \
            or dout.shape != q.shape or Skv < 1:
        raise ValueError(f"flash_attention backward shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)} o {tuple(o.shape)} "
                         f"dout {tuple(dout.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention backward takes head_dim in {HEAD_DIMS}, got {d}")
    _check_lse(q, lse)
    f32 = dict(dtype=torch.float32, device=q.device)
    delta = torch.empty(B * H * S, **f32)
    shares = dtype == _build.DTYPE_CODES[torch.bfloat16] and H > Hkv
    part = torch.empty(2 * B * H * Skv * d if shares else 0, **f32)
    strides = (ctypes.c_longlong * 24)(*(s for t in tensors for s in t.stride()[:3]))
    lib = _build.library("flash_attention_bwd", _BWD_SIGNATURES)
    err = lib.ham_flash_attention_bwd(
        *(t.data_ptr() for t in tensors), lse.data_ptr(), delta.data_ptr(), part.data_ptr(),
        B, H, Hkv, S, Skv, d, int(causal), window or 0, dtype, ctypes.addressof(strides),
        q.device.index, torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(lib, err, "flash_attention backward")
    _build.count(__name__, "launches_backward")
    return dq, dk, dv
