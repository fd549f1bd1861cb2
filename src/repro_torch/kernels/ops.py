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
CUDA call of flash attention or the grouped matmul records its backward
kernels; the mLSTM, SSD and decode kernels have none yet and raise.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import grouped_matmul as gmm
from repro_torch.kernels import mamba2_ssd as _ssd
from repro_torch.kernels import mlstm as _mlstm
from repro_torch.kernels.decode_attention import decode_attention, decode_attention_q8
from repro_torch.kernels.flash_attention import flash_attention_heads


def flash_attention_bhsd(q, k, v, *, causal=True, window=None):
    """q (B, Sq, H, hd); k/v (B, Skv, Hkv, hd) -> (B, Sq, H, hd).  Cross
    attention (Sq != Skv) is non-causal; ``window`` applies only when
    causal."""
    t = lambda a: a.transpose(1, 2)
    return t(flash_attention_heads(t(q), t(k), t(v), causal=causal, window=window))


def decode_attention_bhsd(q, k, v, lengths):
    """q (B, 1, H, hd); k/v caches (B, S, Hkv, hd); lengths (B,) ->
    (B, 1, H, hd).  The cache is read in place through strides."""
    B, _, H, hd = q.shape
    Hkv = k.shape[2]
    q4 = q.reshape(B, Hkv, H // Hkv, hd)
    out = decode_attention(q4, k.transpose(1, 2), v.transpose(1, 2), lengths)
    return out.reshape(B, 1, H, hd)


def decode_attention_q8_bhsd(q, k, v, k_scale, v_scale, lengths):
    """:func:`decode_attention_bhsd` over an int8 cache: k/v int8 (B, S,
    Hkv, hd), k_scale/v_scale float32 (B, S, Hkv, 1), all read in place
    through strides."""
    B, _, H, hd = q.shape
    Hkv = k.shape[2]
    t = lambda a: a.transpose(1, 2)
    out = decode_attention_q8(q.reshape(B, Hkv, H // Hkv, hd), t(k), t(v), t(k_scale),
                              t(v_scale), lengths)
    return out.reshape(B, 1, H, hd)


def grouped_matmul(x, w):
    """x (G, E, C, d) dispatched tokens; w (E, d, f) expert weights ->
    (G, E, C, f), the reference model's ``einsum("gecd,edf->gecf")``.

    G folds into the capacity dim, (E, G*C, d), since w has no G: a view when
    G == 1 (every serving shape), one copy otherwise.  The result is a view
    of the kernel's (E, G*C, f) output.
    """
    G, E, C, d = x.shape
    out = gmm.grouped_matmul(x.transpose(0, 1).reshape(E, G * C, d), w)
    return out.view(E, G, C, -1).transpose(0, 1)


def mlstm_chunked(q, k, v, i_pre, f_pre, state=None, *, chunk=256):
    """Model layout: q, k (B, S, H, dk); v (B, S, H, dv); gates (B, S, H);
    state (C (B,H,dk,dv), n (B,H,dk), m (B,H)) or None.  Returns
    (h (B, S, H, dv), (C, n, m)).  The kernel takes ``chunk`` with a masked
    ragged tail; the plain version shrinks it to divide S."""
    h = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    t = lambda a: a.transpose(1, 2)
    _, st = _mlstm.mlstm_chunked_heads(t(q), t(k), t(v), t(i_pre), t(f_pre), state,
                                       chunk=chunk, out=t(h))
    return h, st


def ssd_chunked(x, dt, A, Bm, Cm, D, state=None, *, chunk=256):
    """Model layout: x (B, S, H, P); dt (B, S, H) float32; A, D (H,)
    float32; Bm, Cm (B, S, G, N); state h (B, H, N, P) float32 or None.
    Returns (y (B, S, H, P) with the D x skip, h).  The kernel takes
    ``chunk`` with a masked ragged tail; the plain version shrinks it to
    divide S."""
    return _ssd.ssd_chunked(x, dt, A, Bm, Cm, D, state, chunk=chunk)
