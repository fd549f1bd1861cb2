"""Plain PyTorch oracles for the attention, grouped-matmul, mLSTM and SSD kernels
(port of ``repro.kernels.ref``, same signatures and layouts), and for the
port's windowed flash and int8 decode variants.

No tiling, no shared-memory reasoning — just the math, in float32, with the
result cast back to the input dtype.  They are the plain versions the CUDA
kernels are held against, and what the wrappers run for CPU tensors.
"""

from __future__ import annotations

import math

import torch

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


def attention_scores_ref(q, k, *, causal=True, q_per_kv=1, window=None):
    """The scaled, masked float32 scores of :func:`attention_ref`: (BH, S,
    Skv), masked keys at ``NEG_INF``."""
    S, d = q.shape[1], q.shape[2]
    kk = k.repeat_interleave(q_per_kv, dim=0).float()
    s = torch.einsum("htd,hsd->hts", q.float(), kk) / math.sqrt(d)
    if causal:
        mask = torch.ones(S, k.shape[1], dtype=torch.bool, device=q.device).tril()
        if window is not None:
            mask = mask.triu(1 - window)
        s = torch.where(mask[None], s, NEG_INF)
    return s


def attention_ref(q, k, v, *, causal=True, q_per_kv=1, window=None):
    """Oracle for flash_attention.  q: (BH,S,d), k/v: (BKV,Skv,d); q row
    ``bh`` reads kv row ``bh // q_per_kv``; causal keeps keys j <= i, and a
    ``window`` (causal only) keys i - window < j <= i, as the reference
    model's ``causal_mask``."""
    s = attention_scores_ref(q, k, causal=causal, q_per_kv=q_per_kv, window=window)
    p = torch.softmax(s, dim=-1)
    vv = v.repeat_interleave(q_per_kv, dim=0).float()
    return torch.einsum("hts,hsd->htd", p, vv).to(q.dtype)


def decode_attention_ref(q, k, v, lengths, *, q_per_kv=1):
    """Oracle for decode_attention.  q: (B, H, d) one token per sequence;
    k/v: (B, Hkv, S, d); lengths: (B,) valid cache length per sequence."""
    d = q.shape[-1]
    S = k.shape[2]
    kk = k.repeat_interleave(q_per_kv, dim=1).float()   # (B, H, S, d)
    vv = v.repeat_interleave(q_per_kv, dim=1).float()
    s = torch.einsum("bhd,bhsd->bhs", q.float(), kk) / math.sqrt(d)
    valid = torch.arange(S, device=q.device)[None, None, :] < lengths[:, None, None]
    s = torch.where(valid, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhs,bhsd->bhd", p, vv).to(q.dtype)


def dequantize_kv(x, scale, dtype):
    """The reference's int8 KV dequantization (``repro/models/layers.py:
    293-294``): ``dtype(x) * dtype(scale)``, rounded to ``dtype``."""
    return x.to(dtype) * scale.to(dtype)


def decode_attention_q8_ref(q, k, v, k_scale, v_scale, lengths, *, q_per_kv=1):
    """Oracle for the int8 decode: k/v int8 (B, Hkv, S, d), scales float32
    (B, Hkv, S, 1), dequantized to q's dtype, then :func:`decode_attention_ref`."""
    return decode_attention_ref(q, dequantize_kv(k, k_scale, q.dtype),
                                dequantize_kv(v, v_scale, q.dtype), lengths,
                                q_per_kv=q_per_kv)


def grouped_matmul_ref(x, w):
    """Oracle for grouped_matmul: per-expert batched GEMM.
    x: (E, C, d), w: (E, d, f) -> (E, C, f), fp32 accumulation."""
    return torch.einsum("ecd,edf->ecf", x.float(), w.float()).to(x.dtype)


def mlstm_chunk_ref(q, k, v, i_pre, f_pre, state=None, *, chunk):
    """Oracle for the mlstm kernel: the port's ``models.xlstm`` chunked
    formulation in model layout (itself held against the recurrence)."""
    from repro_torch.models.xlstm import mlstm_chunked

    return mlstm_chunked(q, k, v, i_pre, f_pre, state, chunk=chunk)


def mlstm_recurrent_ref(q, k, v, i_pre, f_pre, state=None):
    from repro_torch.models.xlstm import mlstm_recurrent

    return mlstm_recurrent(q, k, v, i_pre, f_pre, state)


def ssd_chunk_ref(x, dt, A, Bm, Cm, D, state=None, *, chunk):
    """Oracle for the SSD kernel: the port's ``models.mamba2`` chunked
    formulation in model layout (itself held against the recurrence)."""
    from repro_torch.models.mamba2 import ssd_chunked

    return ssd_chunked(x, dt, A, Bm, Cm, D, state, chunk=chunk)


def ssd_recurrent_ref(x, dt, A, Bm, Cm, D, state=None):
    from repro_torch.models.mamba2 import ssd_recurrent

    return ssd_recurrent(x, dt, A, Bm, Cm, D, state)


def divisor_chunk(chunk: int, S: int) -> int:
    """The reference models' chunk: ``min(chunk, S)``, shrunk until it
    divides S (``repro/models/xlstm.py:257-260``, ``mamba2.py:195-197``)."""
    L = min(chunk, S)
    while S % L:
        L -= 1
    return L
