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
goes through :class:`_FlashAttention`, whose backward launches the backward
kernel (FlashAttention-2's: one block per query tile recomputes the row
log-sum-exp, D = rowsum(dO o O) and dQ; one block per key tile accumulates
dK and dV over the query tiles and the q heads of its kv group; no
atomics, so a step's gradients repeat bit for bit; see the source's note).
Otherwise a call launches the forward exactly as before, so serving's
launches and times do not move.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import attention_ref

HEAD_DIMS = (32, 64, 80, 128, 192)
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "ham_flash_attention": [_P] * 4 + [_I] * 9 + [_L] * 12 + [_I, _P],
}
_BWD_SIGNATURES = {
    "ham_flash_attention_bwd": [_P] * 10 + [_I] * 9 + [_P, _I, _P],
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


def flash_attention_heads_backward_plain(q, k, v, o, dout, *, causal=True, window=None):
    """The plain version of :func:`flash_attention_heads_backward`: autograd
    through :func:`flash_attention_heads_plain` (``o`` is not needed)."""
    del o
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        out = flash_attention_heads_plain(*leaves, causal=causal, window=window)
        return torch.autograd.grad(out, leaves, dout)


def flash_attention_heads_backward(q, k, v, o, dout, *, causal=True, window=None):
    """(dq, dk, dv) of :func:`flash_attention_heads` at (q, k, v), whose
    output was ``o``, for the output gradient ``dout``; each in its input's
    dtype and the model's (B, S, heads, d) layout (returned as (B, heads,
    S, d) views).  CPU tensors take the plain version; CUDA tensors launch
    the backward kernel."""
    if not causal:
        window = None
    if q.device.type == "cpu":
        return flash_attention_heads_backward_plain(q, k, v, o, dout, causal=causal,
                                                    window=window)
    return _launch_backward(q, k, v, o, dout, causal, window)


class _FlashAttention(torch.autograd.Function):
    """The forward kernel with the backward kernel as its gradient."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        out = _launch(q, k, v, causal, window)
        ctx.save_for_backward(q, k, v, out)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out = ctx.saved_tensors
        dq, dk, dv = _launch_backward(q, k, v, out, dout, ctx.causal, ctx.window)
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
    if q.device.type == "cpu":
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


def empty_heads_like(t):
    """An empty (B, heads, S, d) tensor like ``t``, a view of one in the
    model's (B, S, heads, d) layout."""
    B, H, S, d = t.shape
    return torch.empty((B, S, H, d), dtype=t.dtype, device=t.device).transpose(1, 2)


@_build.counted
def _launch(q, k, v, causal, window):
    B, H, S, d = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    out = empty_heads_like(q)
    dtype = _build.check_inputs("flash_attention", (q, k, v, out))
    if k.shape != (B, Hkv, Skv, d) or v.shape != k.shape or H % Hkv:
        raise ValueError(f"flash_attention shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes head_dim in {HEAD_DIMS}, got {d}")
    lib = _build.library("flash_attention", _SIGNATURES)
    err = lib.ham_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, H, Hkv, S, Skv, d, int(causal), window or 0, dtype,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        q.device.index, torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(lib, err, "flash_attention")
    if window:
        _build.count(__name__, "launches_window")
    return out


def _launch_backward(q, k, v, o, dout, causal, window):
    """Launch the backward kernel: (dq, dk, dv) in the (B, S, heads, d)
    layout, returned as (B, heads, S, d) views; float32 scratch for the row
    log-sum-exp and D."""
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
    f32 = dict(dtype=torch.float32, device=q.device)
    lse, delta = torch.empty(B * H * S, **f32), torch.empty(B * H * S, **f32)
    strides = (ctypes.c_longlong * 24)(*(s for t in tensors for s in t.stride()[:3]))
    lib = _build.library("flash_attention_bwd", _BWD_SIGNATURES)
    err = lib.ham_flash_attention_bwd(
        *(t.data_ptr() for t in tensors), lse.data_ptr(), delta.data_ptr(),
        B, H, Hkv, S, Skv, d, int(causal), window or 0, dtype, ctypes.addressof(strides),
        q.device.index, torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(lib, err, "flash_attention backward")
    _build.count(__name__, "launches_backward")
    return dq, dk, dv
