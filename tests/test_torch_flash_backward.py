"""The flash-attention backward and the grouped-matmul backward, on the CPU.

* ``flash_attention_heads_backward_plain`` (autograd through the plain
  attention) against ``jax.grad`` of the reference's ``attention_ref``
  (``repro/kernels/ref.py:17``) for GQA, causal, non-causal and cross
  attention, and of the reference model's ``causal_mask(window=)``
  attention for a sliding window; float32, 2e-5 (the forward's tolerance:
  both sum the same products in float32, in other orders).
* a numpy model of ``csrc/flash_attention_bwd.cu``'s tile walk: each
  64-query tile's LSE recomputed over its 64-key tiles (online max and sum
  from the finite -0.7 FLT_MAX mask value), D = rowsum(dO o O) and dQ over
  the same key tiles; each 64-key tile's dK and dV accumulated over the
  32-query tiles of every q head in its kv group (from the causal diagonal
  to the window's far edge); causal, window and ragged-tail masking.  It
  must equal autograd (float32 model against a float64 autograd, 1e-5
  absolute on unit-scale inputs), so the kernel's algorithm is checked
  before the card runs it.
* the autograd routes (``_FlashAttention``, ``_GroupedMatmul``) with their
  launches swapped for the plain versions, and the grouped-matmul
  backward's transposed, padded operands against the plain autograd
  (float32 2e-5, a ragged capacity included).
* the mLSTM, SSD and decode wrappers raise under grad for a non-CPU
  request (``meta`` tensors, as the dispatch tests of
  ``test_torch_package.py``), before any launch.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ref import attention_ref as jax_attention_ref
from repro.models import layers as JL
from repro_torch.kernels import decode_attention as dec
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import grouped_matmul as gmm
from repro_torch.kernels import mamba2_ssd as ssd
from repro_torch.kernels import mlstm
from repro_torch.kernels import ops

ATOL = 2e-5
NEG = np.float32(-0.7 * np.finfo(np.float32).max)


def _qkvo(seed, B, H, Hkv, S, Skv, d, dtype=np.float32):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, S, d)).astype(dtype)
    k = rng.standard_normal((B, Hkv, Skv, d)).astype(dtype)
    v = rng.standard_normal((B, Hkv, Skv, d)).astype(dtype)
    do = rng.standard_normal((B, H, S, d)).astype(dtype)
    return q, k, v, do


CASES = [  # B, H, Hkv, S, Skv, d, causal, window
    (2, 4, 2, 37, 37, 16, True, None),
    (1, 6, 2, 70, 70, 32, True, None),
    (2, 4, 4, 29, 29, 16, False, None),
    (1, 4, 2, 19, 45, 16, False, None),    # cross attention, Sq != Skv
    (1, 4, 1, 100, 100, 16, True, 7),
    (1, 2, 2, 130, 130, 32, True, 64),
]
IDS = ["gqa_causal", "gqa_causal_2tiles", "noncausal", "cross", "window7", "window64"]


def _jax_grads(q, k, v, do, causal, window):
    B, H, S, d = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]

    if window is None:
        def f(q, k, v):
            out = jax_attention_ref(q.reshape(B * H, S, d), k.reshape(B * Hkv, Skv, d),
                                    v.reshape(B * Hkv, Skv, d), causal=causal,
                                    q_per_kv=H // Hkv)
            return jnp.sum(out.reshape(B, H, S, d) * do)
    else:
        def f(q, k, v):
            t = lambda a: jnp.swapaxes(a, 1, 2)
            out = JL.gqa_scores_softmax_value(t(q), t(k), t(v),
                                              JL.causal_mask(S, Skv, window=window),
                                              q_per_kv=H // Hkv)
            return jnp.sum(t(out) * do)

    return [np.asarray(g) for g in jax.grad(f, argnums=(0, 1, 2))(q, k, v)]


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plain_backward_matches_jax_grad(case):
    B, H, Hkv, S, Skv, d, causal, window = case
    q, k, v, do = _qkvo(1, B, H, Hkv, S, Skv, d)
    want = _jax_grads(q, k, v, do, causal, window)
    t = torch.from_numpy
    o = fa.flash_attention_heads_plain(t(q), t(k), t(v), causal=causal, window=window)
    got = fa.flash_attention_heads_backward(t(q), t(k), t(v), o, t(do), causal=causal,
                                            window=window)
    for g, w, name in zip(got, want, "qkv"):
        np.testing.assert_allclose(g.numpy(), w, atol=ATOL, rtol=ATOL, err_msg=f"d{name}")


# -- the kernel's tile walk, in numpy ----------------------------------------------

KEYS, PQ, MQ = 64, 64, 32   # csrc/flash_attention_bwd.cu kKeys, kQ, kMQ


def _masked(key, row, Skv, causal, window):
    m = key >= Skv
    if causal:
        m = m | (key > row)
    if window:
        m = m | (key <= row - window)
    return m


def _kernel_model(q, k, v, o, do, causal, window):
    """csrc/flash_attention_bwd.cu, tile by tile, in float32."""
    B, H, S, d = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    qpk, scale = H // Hkv, np.float32(1.0 / math.sqrt(d))
    window = window if causal else 0
    lse = np.zeros((B, H, S), np.float32)
    delta = np.zeros((B, H, S), np.float32)
    dq = np.zeros(q.shape, np.float32)
    dk = np.zeros(k.shape, np.float32)
    dv = np.zeros(v.shape, np.float32)
    pad = lambda a, rows: np.concatenate([a, np.zeros((rows - len(a), d), np.float32)])
    # dq kernel: one block per (b, h, 64-query tile); pass 1 the LSE, pass 2 dQ
    for b in range(B):
        for h in range(H):
            hk = h // qpk
            for q0 in range(0, S, PQ):
                rows = np.arange(q0, q0 + PQ)
                qs, dos = pad(q[b, h, q0:q0 + PQ], PQ), pad(do[b, h, q0:q0 + PQ], PQ)
                m = np.full(PQ, NEG, np.float32)
                l = np.zeros(PQ, np.float32)
                q_last = min(q0 + PQ, S) - 1
                k_end = min(Skv, q_last + 1) if causal else Skv
                k_begin = max(0, q0 - window + 1) // KEYS * KEYS if window else 0
                for k0 in range(k_begin, k_end, KEYS):
                    keys = np.arange(k0, k0 + KEYS)
                    s = (qs @ pad(k[b, hk, k0:k0 + KEYS], KEYS).T) * scale
                    s = np.where(_masked(keys[None], rows[:, None], Skv, causal, window), NEG, s)
                    m_new = np.maximum(m, s.max(1))
                    with np.errstate(over="ignore"):
                        l = np.exp(m - m_new) * l + np.exp(s - m_new[:, None]).sum(1)
                    m = m_new
                lse_t = m + np.log(np.maximum(l, 1e-30))
                del_t = (pad(o[b, h, q0:q0 + PQ], PQ) * dos).sum(1)
                valid = rows < S
                lse[b, h, rows[valid]] = lse_t[valid]
                delta[b, h, rows[valid]] = del_t[valid]
                acc = np.zeros((PQ, d), np.float32)
                for k0 in range(k_begin, k_end, KEYS):
                    keys = np.arange(k0, k0 + KEYS)
                    ks, vs = pad(k[b, hk, k0:k0 + KEYS], KEYS), pad(v[b, hk, k0:k0 + KEYS], KEYS)
                    s, dp = (qs @ ks.T) * scale, dos @ vs.T
                    off = ~valid[:, None] | _masked(keys[None], rows[:, None], Skv, causal,
                                                    window)
                    with np.errstate(over="ignore"):   # masked rows past S: discarded
                        p = np.where(off, 0, np.exp(s - lse_t[:, None]))
                    acc += (p * (dp - del_t[:, None])) @ ks
                dq[b, h, rows[valid]] = (acc * scale)[valid]
    # dk/dv kernel: one block per (b, hk, 64-key tile)
    for b in range(B):
        for hk in range(Hkv):
            for k0 in range(0, Skv, KEYS):
                ks, vs = pad(k[b, hk, k0:k0 + KEYS], KEYS), pad(v[b, hk, k0:k0 + KEYS], KEYS)
                keys = np.arange(k0, k0 + KEYS)
                q_begin = k0 // MQ * MQ if causal else 0
                q_end = min(S, k0 + KEYS - 1 + window) if window else S
                dka = np.zeros((KEYS, d), np.float32)
                dva = np.zeros((KEYS, d), np.float32)
                for g in range(qpk):
                    h = hk * qpk + g
                    for q0 in range(q_begin, q_end, MQ):
                        rows = np.arange(q0, q0 + MQ)
                        qs, dos = pad(q[b, h, q0:q0 + MQ], MQ), pad(do[b, h, q0:q0 + MQ], MQ)
                        ok = rows < S
                        lse_t = np.where(ok, lse[b, h, np.minimum(rows, S - 1)], 0)
                        del_t = np.where(ok, delta[b, h, np.minimum(rows, S - 1)], 0)
                        s, dp = qs @ ks.T, dos @ vs.T
                        off = ~ok[:, None] | _masked(keys[None], rows[:, None], Skv, causal,
                                                     window)
                        p = np.where(off, 0, np.exp(s * scale - lse_t[:, None]))
                        ds = p * (dp - del_t[:, None])
                        dva += p.T @ dos
                        dka += ds.T @ qs
                n = min(KEYS, Skv - k0)
                dk[b, hk, k0:k0 + n] = (dka * scale)[:n]
                dv[b, hk, k0:k0 + n] = dva[:n]
    return dq, dk, dv


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_kernel_tile_walk_equals_autograd(case):
    B, H, Hkv, S, Skv, d, causal, window = case
    q, k, v, do = _qkvo(2, B, H, Hkv, S, Skv, d)
    t = lambda a: torch.from_numpy(a).double()
    o = fa.flash_attention_heads_plain(t(q), t(k), t(v), causal=causal, window=window)
    want = fa.flash_attention_heads_backward_plain(t(q), t(k), t(v), o, t(do),
                                                   causal=causal, window=window)
    got = _kernel_model(q, k, v, o.float().numpy(), do, causal, window)
    for g, w, name in zip(got, want, "qkv"):
        np.testing.assert_allclose(g, w.numpy(), atol=1e-5, rtol=1e-5, err_msg=f"d{name}")


# -- the autograd routes, launches swapped for the plain versions ---------------------


def test_flash_autograd_function_plumbing(monkeypatch):
    """``_FlashAttention`` saves what its backward reads and returns
    gradients in the inputs' shapes: with the launches swapped for the
    plain versions it equals autograd through the plain attention."""
    calls = []

    def fwd(q, k, v, causal, window):
        calls.append("fwd")
        out = fa.empty_heads_like(q)   # the kernel's output, as _launch allocates it
        return out.copy_(fa.flash_attention_heads_plain(q, k, v, causal=causal, window=window))

    def bwd(q, k, v, o, dout, causal, window):
        calls.append("bwd")
        return fa.flash_attention_heads_backward_plain(q, k, v, o, dout, causal=causal,
                                                       window=window)

    monkeypatch.setattr(fa, "_launch", fwd)
    monkeypatch.setattr(fa, "_launch_backward", bwd)
    q, k, v, do = (torch.from_numpy(a) for a in _qkvo(3, 2, 4, 2, 21, 21, 16))
    # the model's layout: (B, S, heads, d) tensors seen as (B, heads, S, d)
    leaves = [a.transpose(1, 2).contiguous().requires_grad_(True) for a in (q, k, v)]
    heads = [a.transpose(1, 2) for a in leaves]
    out = fa._FlashAttention.apply(*heads, True, 5)
    assert out.shape == q.shape and out.transpose(1, 2).is_contiguous()
    (out * do).sum().backward()
    assert calls == ["fwd", "bwd"]
    want = fa.flash_attention_heads_backward_plain(q, k, v, None, do, causal=True, window=5)
    for leaf, w in zip(leaves, want):
        np.testing.assert_allclose(leaf.grad.transpose(1, 2).numpy(), w.numpy(), atol=ATOL)


@pytest.mark.parametrize("C", [8, 37, 160])
def test_grouped_matmul_backward_operands(C):
    """dx = dy w^T and dw = x^T dy on the operands the kernel is given
    (w^T contiguous; x^T with rows padded to 8 elements, viewed at C)."""
    rng = np.random.default_rng(C)
    E, d, f = 4, 48, 40
    x = torch.from_numpy(rng.standard_normal((E, C, d)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((E, d, f)).astype(np.float32))
    dy = torch.from_numpy(rng.standard_normal((E, C, f)).astype(np.float32))
    (a0, b0), (a1, b1) = gmm.backward_operands(x, w, dy)
    assert a1.shape == (E, d, C) and a1.stride(1) % 8 == 0 and a1.stride(-1) == 1
    assert b0.is_contiguous() and b0.shape == (E, f, d)
    want = gmm.grouped_matmul_backward_plain(x, w, dy)
    for got, ref in zip((gmm.grouped_matmul_plain(a0, b0), gmm.grouped_matmul_plain(a1, b1)),
                        want):
        np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=ATOL, rtol=ATOL)


def test_grouped_matmul_autograd_function_plumbing(monkeypatch):
    launched = []

    def plain_launch(x, w):
        launched.append(tuple(x.shape))
        return gmm.grouped_matmul_plain(x, w)

    monkeypatch.setattr(gmm, "_launch", plain_launch)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((3, 13, 24)).astype(np.float32)).requires_grad_()
    w = torch.from_numpy(rng.standard_normal((3, 24, 16)).astype(np.float32)).requires_grad_()
    dy = torch.from_numpy(rng.standard_normal((3, 13, 16)).astype(np.float32))
    (gmm._GroupedMatmul.apply(x, w) * dy).sum().backward()
    assert launched == [(3, 13, 24), (3, 13, 16), (3, 24, 13)]   # forward, dx, dw
    want = gmm.grouped_matmul_backward_plain(x, w, dy)
    np.testing.assert_allclose(x.grad.numpy(), want[0].numpy(), atol=ATOL)
    np.testing.assert_allclose(w.grad.numpy(), want[1].numpy(), atol=ATOL)


# -- kernels without a backward raise under grad ------------------------------------


def _counts():
    return (dec.launches, dec.launches_q8, mlstm.launches, ssd.launches, fa.launches,
            fa.launches_backward, gmm.launches)


def _meta(*shape, grad=True):
    return torch.empty(shape, device="meta").requires_grad_(grad)


@pytest.mark.parametrize("kernel", ["mlstm", "mamba2_ssd", "decode_attention",
                                    "decode_attention_q8"])
def test_kernels_without_backward_raise_under_grad(kernel):
    item = {"mlstm": "12b", "mamba2_ssd": "12c"}.get(kernel, "12d")
    before = _counts()
    with pytest.raises(NotImplementedError, match=f"item {item}"):
        if kernel == "mlstm":
            qk = _meta(2, 37, 2, 16)
            ops.mlstm_chunked(qk, qk, _meta(2, 37, 2, 32), _meta(2, 37, 2), _meta(2, 37, 2),
                              chunk=8)
        elif kernel == "mamba2_ssd":
            bc = _meta(2, 37, 2, 64)
            ops.ssd_chunked(_meta(2, 37, 4, 64), _meta(2, 37, 4), _meta(4), bc, bc, _meta(4),
                            chunk=8)
        elif kernel == "decode_attention":
            kv = _meta(2, 16, 2, 32, grad=False)
            ops.decode_attention_bhsd(_meta(2, 1, 8, 32), kv, kv,
                                      torch.empty(2, dtype=torch.int32, device="meta"))
        else:
            kv = torch.empty(2, 16, 2, 32, dtype=torch.int8, device="meta")
            sc = _meta(2, 16, 2, 1, grad=False)
            ops.decode_attention_q8_bhsd(_meta(2, 1, 8, 32), kv, kv, sc, sc,
                                         torch.empty(2, dtype=torch.int32, device="meta"))
    assert _counts() == before
    with torch.no_grad():   # no graph recorded: the launch path as before
        with pytest.raises(ValueError, match="CUDA"):
            ops.decode_attention_bhsd(_meta(2, 1, 8, 32), _meta(2, 16, 2, 32),
                                      _meta(2, 16, 2, 32),
                                      torch.empty(2, dtype=torch.int32, device="meta"))


def test_flash_and_grouped_matmul_take_the_autograd_route_under_grad(monkeypatch):
    """A non-CPU call under grad goes through the autograd Functions, whose
    forward is the same kernel launch (raising here, where there is no
    card), and counts nothing before it launches."""
    seen = []
    monkeypatch.setattr(fa._FlashAttention, "apply",
                        staticmethod(lambda *a: seen.append("flash") or a[0]))
    monkeypatch.setattr(gmm._GroupedMatmul, "apply",
                        staticmethod(lambda *a: seen.append("gmm") or a[0]))
    q, kv = _meta(2, 16, 8, 32), _meta(2, 16, 2, 32)
    ops.flash_attention_bhsd(q, kv, kv)
    ops.grouped_matmul(_meta(1, 4, 8, 32), _meta(4, 32, 16))
    assert seen == ["flash", "gmm"]
    before = _counts()
    with torch.no_grad():
        with pytest.raises(ValueError, match="CUDA"):
            ops.flash_attention_bhsd(q, kv, kv)
    assert _counts() == before
