"""Flash attention (tiled online softmax, GQA-aware, forward only): a CUDA
kernel written by hand for Hopper (``csrc/flash_attention.cu``) beside its
plain version.

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
* GQA reads kv head ``h // q_per_kv`` (the Pallas kernel's
  ``bh // q_per_kv``), so repeated K/V are never materialised;
* q/k/v/o are read and written through strides, so the model's
  ``(B, S, H, d)`` activations need no transpose copies.

float32 runs a CUDA-core kernel (float32 tiles in shared memory): the
tensor cores take float32 only as TF32, which would miss the float32
tolerance.  ``wgmma``, TMA and warp specialisation are later work.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import attention_ref

HEAD_DIMS = (32, 64, 80, 128)
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "ham_flash_attention": [_P] * 4 + [_I] * 8 + [_L] * 12 + [_I, _P],
}

#: kernel launches made by :func:`flash_attention_heads` (plain calls not counted)
launches = 0


def flash_attention_heads_plain(q, k, v, *, causal=True):
    """The plain PyTorch version of :func:`flash_attention_heads`."""
    B, H, S, d = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    out = attention_ref(
        q.reshape(B * H, S, d), k.reshape(B * Hkv, Skv, d),
        v.reshape(B * Hkv, Skv, d), causal=causal, q_per_kv=H // Hkv,
    )
    return out.reshape(B, H, S, d)


def flash_attention_heads(q, k, v, *, causal=True, out=None):
    """q: (B, H, S, d); k/v: (B, Hkv, Skv, d) with H % Hkv == 0; any
    strides with a unit last dim.  Query head h reads kv head
    ``h // (H // Hkv)``; causal masks key j > query i.  Returns (B, H, S, d),
    written into ``out`` if given.

    CPU tensors take the plain version; CUDA tensors launch the kernel.
    """
    if q.device.type == "cpu":
        res = flash_attention_heads_plain(q, k, v, causal=causal)
        return res if out is None else out.copy_(res)
    return _launch(q, k, v, causal, out)


def flash_attention(q, k, v, *, causal=True, q_per_kv=1):
    """The reference's signature: q (BH, S, d); k, v (BKV, Skv, d) with
    BH = BKV * q_per_kv (q row bh reads kv row bh // q_per_kv)."""
    if q.shape[0] != k.shape[0] * q_per_kv:
        raise ValueError(f"BH={q.shape[0]} != BKV={k.shape[0]} * q_per_kv={q_per_kv}")
    return flash_attention_heads(q[None], k[None], v[None], causal=causal)[0]


@_build.counted
def _launch(q, k, v, causal, out):
    B, H, S, d = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    if out is None:
        out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dtype = _build.check_inputs("flash_attention", (q, k, v, out))
    if k.shape != (B, Hkv, Skv, d) or v.shape != k.shape or H % Hkv:
        raise ValueError(f"flash_attention shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes head_dim in {HEAD_DIMS}, got {d}")
    if out.shape != q.shape:
        raise ValueError("flash_attention out must match q in shape")
    lib = _build.library("flash_attention", _SIGNATURES)
    err = lib.ham_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, H, Hkv, S, Skv, d, int(causal), dtype,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        q.device.index, torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(lib, err, "flash_attention")
    return out
