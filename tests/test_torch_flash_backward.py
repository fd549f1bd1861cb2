"""The flash-attention backward and the grouped-matmul backward, on the CPU.

* ``flash_attention_heads_backward_plain`` (autograd through the plain
  attention) against ``jax.grad`` of the reference's ``attention_ref``
  (``repro/kernels/ref.py:17``) for GQA, causal, non-causal and cross
  attention, and of the reference model's ``causal_mask(window=)``
  attention for a sliding window; float32, 2e-5 (the forward's tolerance:
  both sum the same products in float32, in other orders).
* ``flash_attention_heads_lse_plain``, the row log-sum-exp the forward
  kernel saves for its backward, against ``jax.nn.logsumexp`` of the
  reference's scaled, masked scores (``attention_ref``'s, and
  ``causal_mask(window=)``'s for a window) for every case (GQA, causal,
  non-causal, cross, windows, ragged tiles); float32, 1e-5.
* a numpy model of ``csrc/flash_attention_bwd.cu``'s tile walk, given the
  LSE: D = rowsum(dO o O); each q head's share of a 64-key tile's dK and dV
  accumulated by 16-key warps over its query steps (64, 32 or 16 queries by
  head_dim), from the causal diagonal to the window's far edge, a warp
  skipping a step wholly outside its keys' masks, and the shares of a kv
  group's q heads added in head order; dQ by 16-row warps
  of the forward's query tiles over 64-key tiles from the window's near
  edge to the diagonal; masks on the crossing tiles only.  It must equal
  autograd: in float32 (against a float64 autograd, 1e-5 absolute on
  unit-scale inputs) and with P and dS rounded to bf16 as the kernel's mma
  operands are (bf16 inputs, against a float32 autograd, within the card's
  bf16 limit: 0.5 of the plain gradient's RMS), so the kernel's algorithm
  is checked before the card runs it.
* the autograd routes (``_FlashAttention``, ``_GroupedMatmul``) with their
  launches swapped for the plain versions: the forward saves the LSE and
  the backward receives it, with no second forward; a backward called
  without an LSE launches the forward once to write it; the grouped-matmul
  backward's transposed, padded operands against the plain autograd
  (float32 2e-5, a ragged capacity included).
* the decode wrappers raise under grad for a non-CPU request (``meta``
  tensors, as the dispatch tests of ``test_torch_package.py``), before any
  launch; the mLSTM and SSD wrappers take their autograd Functions there
  (their backward kernels are held in ``test_torch_mlstm_backward.py`` and
  ``test_torch_ssd_backward.py``).
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


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plain_lse_matches_jax_logsumexp(case):
    B, H, Hkv, S, Skv, d, causal, window = case
    q, k, v, _ = _qkvo(4, B, H, Hkv, S, Skv, d)
    kk = jnp.repeat(jnp.asarray(k), H // Hkv, axis=1)
    s = jnp.einsum("bhtd,bhsd->bhts", jnp.asarray(q), kk) / np.sqrt(d)
    if causal:
        s = jnp.where(JL.causal_mask(S, Skv, window=window)[0], s, NEG)
    want = np.asarray(jax.nn.logsumexp(s, axis=-1))
    got = fa.flash_attention_heads_lse_plain(torch.from_numpy(q), torch.from_numpy(k),
                                             torch.from_numpy(v), causal=causal, window=window)
    assert got.dtype == torch.float32 and got.shape == (B, H, S)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


# -- the kernel's tile walk, in numpy ----------------------------------------------

KEYS = 64           # csrc/flash_attention_bwd.cu: keys of a dK/dV block (16 a warp) ...
DQ_KEYS = 64        # ... and of a dQ kernel's K/V tile


def _q_step(d):     # csrc/flash_attention_bwd.cu q_step<D>
    return 64 if d <= 64 else 32 if d <= 128 else 16


def _dq_rows(d):    # 16 rows a warp, dq_warps<D> warps
    return 16 * (8 if d >= 80 else 4)


def _masked(key, row, S, Skv, causal, window):
    m = (key >= Skv) | (row >= S)
    if causal:
        m = m | (key > row)
    if window:
        m = m | (key <= row - window)
    return m


def _bf16(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(torch.bfloat16).float().numpy()


def _kernel_model(q, k, v, o, do, lse, causal, window, rounded=False):
    """csrc/flash_attention_bwd.cu, tile by tile, in float32, given the
    forward's lse; ``rounded``: P and dS rounded to bf16 as mma operands."""
    B, H, S, d = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    qpk, scale = H // Hkv, np.float32(1.0 / math.sqrt(d))
    window = window if causal else 0
    op = _bf16 if rounded else (lambda a: a)
    delta = (o.astype(np.float32) * do).sum(-1)
    dq = np.zeros(q.shape, np.float32)
    dk = np.zeros(k.shape, np.float32)
    dv = np.zeros(v.shape, np.float32)
    QB, RQ = _q_step(d), _dq_rows(d)

    def rows_of(a, r0, n, limit):   # rows [r0, r0 + n) of a, zero past limit
        out = np.zeros((n, d), np.float32)
        m = max(0, min(n, limit - r0))
        out[:m] = a[r0:r0 + m]
        return out

    def pick(a, r0, n, limit):      # entries [r0, r0 + n) of a 1-d array, zero past limit
        out = np.zeros(n, np.float32)
        m = max(0, min(n, limit - r0))
        out[:m] = a[r0:r0 + m]
        return out

    # dK/dV: a block per (b, q head, 64 keys), a warp per 16 keys; the
    # shares of a kv group's q heads added in head order
    for b in range(B):
        for hk in range(Hkv):
            for k0 in range(0, Skv, KEYS):
                q_begin = min(k0, S) // QB * QB if causal else 0
                q_end = min(S, k0 + KEYS - 1 + window) if window else S
                for w0 in range(k0, k0 + KEYS, 16):
                    ks, vs = rows_of(k[b, hk], w0, 16, Skv), rows_of(v[b, hk], w0, 16, Skv)
                    keys = np.arange(w0, w0 + 16)
                    dka = np.zeros((16, d), np.float32)
                    dva = np.zeros((16, d), np.float32)
                    for g in range(qpk):
                        h = hk * qpk + g
                        dks = np.zeros((16, d), np.float32)
                        dvs = np.zeros((16, d), np.float32)
                        for q0 in range(q_begin, q_end, QB):
                            if causal and q0 + QB - 1 < w0:
                                continue
                            if window and q0 >= w0 + 15 + window:
                                continue
                            qs, dos = rows_of(q[b, h], q0, QB, S), rows_of(do[b, h], q0, QB, S)
                            ls, ds_ = pick(lse[b, h], q0, QB, S), pick(delta[b, h], q0, QB, S)
                            cols = np.arange(q0, q0 + QB)
                            st, dpt = ks @ qs.T, vs @ dos.T           # keys x queries
                            with np.errstate(over="ignore"):   # masked entries: discarded
                                p = np.exp(st * scale - ls[None])
                            p = np.where(_masked(keys[:, None], cols[None], S, Skv, causal,
                                                 window), 0, p).astype(np.float32)
                            dst = p * (dpt - ds_[None])
                            dvs += op(p) @ dos
                            dks += op(dst) @ qs
                        dka += dks
                        dva += dvs
                    n = max(0, min(16, Skv - w0))
                    dk[b, hk, w0:w0 + n] = (dka * scale)[:n]
                    dv[b, hk, w0:w0 + n] = dva[:n]
    # dQ: a block per (b, h, RQ rows), a warp per 16 rows
    for b in range(B):
        for h in range(H):
            hk = h // qpk
            for q0 in range(0, S, RQ):
                q_last = min(q0 + RQ, S) - 1
                k_end = min(Skv, q_last + 1) if causal else Skv
                k_begin = max(0, q0 - window + 1) // DQ_KEYS * DQ_KEYS if window else 0
                for wq in range(q0, q0 + RQ, 16):
                    qs, dos = rows_of(q[b, h], wq, 16, S), rows_of(do[b, h], wq, 16, S)
                    ls, ds_ = pick(lse[b, h], wq, 16, S), pick(delta[b, h], wq, 16, S)
                    rows = np.arange(wq, wq + 16)
                    acc = np.zeros((16, d), np.float32)
                    for k0 in range(k_begin, k_end, DQ_KEYS):
                        if causal and k0 > wq + 15:
                            continue
                        if window and k0 + DQ_KEYS - 1 <= wq - window:
                            continue
                        ks = rows_of(k[b, hk], k0, DQ_KEYS, Skv)
                        vs = rows_of(v[b, hk], k0, DQ_KEYS, Skv)
                        keys = np.arange(k0, k0 + DQ_KEYS)
                        with np.errstate(over="ignore"):
                            p = np.exp((qs @ ks.T) * scale - ls[:, None])
                        p = np.where(_masked(keys[None], rows[:, None], S, Skv, causal, window),
                                     0, p).astype(np.float32)
                        acc += op(p * (dos @ vs.T - ds_[:, None])) @ ks
                    n = max(0, min(16, S - wq))
                    dq[b, h, wq:wq + n] = (acc * scale)[:n]
    return dq, dk, dv


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_kernel_tile_walk_equals_autograd(case):
    B, H, Hkv, S, Skv, d, causal, window = case
    q, k, v, do = _qkvo(2, B, H, Hkv, S, Skv, d)
    t = lambda a: torch.from_numpy(a).double()
    o = fa.flash_attention_heads_plain(t(q), t(k), t(v), causal=causal, window=window)
    lse = fa.flash_attention_heads_lse_plain(t(q), t(k), t(v), causal=causal, window=window)
    want = fa.flash_attention_heads_backward_plain(t(q), t(k), t(v), o, t(do),
                                                   causal=causal, window=window)
    got = _kernel_model(q, k, v, o.float().numpy(), do, lse.numpy(), causal, window)
    for g, w, name in zip(got, want, "qkv"):
        np.testing.assert_allclose(g, w.numpy(), atol=1e-5, rtol=1e-5, err_msg=f"d{name}")


BF16_GRAD_TOL = 0.5   # chip_smoke.py GRAD_TOL["bfloat16"]: max |kernel - plain| / rms(plain)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_kernel_tile_walk_bf16_operands_within_the_bf16_limit(case):
    """P and dS rounded to bf16 before each product, as the kernel's bf16
    route feeds them to mma.sync, on bf16 inputs: within the card's bf16
    limit of the float32 autograd."""
    B, H, Hkv, S, Skv, d, causal, window = case
    q, k, v, do = (_bf16(a) for a in _qkvo(5, B, H, Hkv, S, Skv, d))
    t = torch.from_numpy
    o = _bf16(fa.flash_attention_heads_plain(t(q), t(k), t(v), causal=causal,
                                             window=window).numpy())
    lse = fa.flash_attention_heads_lse_plain(t(q), t(k), t(v), causal=causal, window=window)
    want = fa.flash_attention_heads_backward_plain(t(q), t(k), t(v), None, t(do),
                                                   causal=causal, window=window)
    got = _kernel_model(q, k, v, o, do, lse.numpy(), causal, window, rounded=True)
    for g, w, name in zip(got, want, "qkv"):
        w = w.numpy()
        err = np.abs(g - w).max() / np.sqrt(np.mean(w ** 2))
        assert err <= BF16_GRAD_TOL, f"d{name}: max err / rms {err:.3g}"


# -- the autograd routes, launches swapped for the plain versions ---------------------


def test_flash_autograd_function_plumbing(monkeypatch):
    """``_FlashAttention`` saves what its backward reads, the forward's LSE
    among it, and returns gradients in the inputs' shapes: with the launches
    swapped for the plain versions it equals autograd through the plain
    attention, and the backward launches no second forward."""
    calls, saved = [], []

    def fwd(q, k, v, causal, window, lse=None):
        calls.append("fwd")
        assert lse is not None and lse.shape == q.shape[:3] and lse.dtype == torch.float32
        lse.copy_(fa.flash_attention_heads_lse_plain(q, k, v, causal=causal, window=window))
        saved.append(lse)
        out = fa.empty_heads_like(q)   # the kernel's output, as _launch allocates it
        return out.copy_(fa.flash_attention_heads_plain(q, k, v, causal=causal, window=window))

    def bwd(q, k, v, o, dout, causal, window, lse):
        calls.append("bwd")
        assert lse is saved[0]
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


@pytest.mark.parametrize("given", [False, True], ids=["lse_none", "lse_given"])
def test_backward_launches_the_forward_only_without_an_lse(given, monkeypatch):
    """A non-CPU backward call without ``lse`` launches the forward once
    (counted in ``launches``) to write it and hands that tensor to the
    backward launch; with ``lse`` it launches the backward alone."""
    calls = []

    def fwd(q, k, v, causal, window, lse=None):
        calls.append(("fwd", lse))
        return q

    def bwd(q, k, v, o, dout, causal, window, lse):
        calls.append(("bwd", lse))
        return q, k, v

    monkeypatch.setattr(fa, "_launch", fwd)
    monkeypatch.setattr(fa, "_launch_backward", bwd)
    q, kv = _meta(2, 8, 16, 32, grad=False), _meta(2, 2, 16, 32, grad=False)
    lse = fa.empty_lse(q) if given else None
    fa.flash_attention_heads_backward(q, kv, kv, q, q, causal=True, lse=lse)
    if given:
        assert calls == [("bwd", lse)]
    else:
        (f, written), (b, read) = calls
        assert (f, b) == ("fwd", "bwd") and written is read
        assert written.shape == (2, 8, 16) and written.dtype == torch.float32


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


@pytest.mark.parametrize("kernel", ["decode_attention", "decode_attention_q8"])
def test_kernels_without_backward_raise_under_grad(kernel):
    before = _counts()
    with pytest.raises(NotImplementedError, match="item 12d"):
        if kernel == "decode_attention":
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


@pytest.mark.parametrize("kernel", ["mlstm", "mamba2_ssd"])
def test_scan_kernels_take_the_autograd_route_under_grad(kernel, monkeypatch):
    """A non-CPU mLSTM or SSD call under grad with no initial state goes
    through its autograd Function (the mLSTM's without ``out=``: the model
    layout's h is the Function's output), and counts nothing before it
    launches; without grad it launches as before (raising here, where there
    is no card)."""
    seen = []
    if kernel == "mlstm":
        def fake(*a):
            seen.append(a[-1])
            return (torch.empty(a[2].shape, device="meta"), torch.empty(1, device="meta"),
                    torch.empty(1, device="meta"), torch.empty(1, device="meta"))

        monkeypatch.setattr(mlstm._MLSTM, "apply", staticmethod(fake))
        qk, v, gates = _meta(2, 37, 2, 16), _meta(2, 37, 2, 32), _meta(2, 37, 2)
        h, _ = ops.mlstm_chunked(qk, qk, v, gates, gates, chunk=8)
        assert h.shape == (2, 37, 2, 32)
        call = lambda: ops.mlstm_chunked(qk, qk, v, gates, gates, chunk=8)
    else:
        monkeypatch.setattr(ssd._SSD, "apply",
                            staticmethod(lambda *a: seen.append(a[-1]) or (a[0], None)))
        bc = _meta(2, 37, 1, 64)
        args = (_meta(2, 37, 4, 64), _meta(2, 37, 4), _meta(4), bc, bc, _meta(4))
        ops.ssd_chunked(*args, chunk=8)
        call = lambda: ops.ssd_chunked(*args, chunk=8)
    assert seen == [8]
    before = _counts()
    with torch.no_grad():
        with pytest.raises(ValueError, match="CUDA"):
            call()
    assert _counts() == before
