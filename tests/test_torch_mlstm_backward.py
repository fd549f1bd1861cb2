"""The mLSTM backward (``repro_torch/kernels/csrc/mlstm_bwd.cu``), on the CPU.

* ``mlstm_chunked_heads_backward_plain`` (autograd through the plain
  chunked form) against ``jax.vjp`` of the reference's ``mlstm_chunked``
  (``repro/models/xlstm.py:63``) on the same numpy-seeded inputs and
  cotangent; float32, max |torch - jax| <= 1e-4 x max |jax| (both sum the
  same float32 products in other orders; the reference's ``exp`` of a
  masked exponent is kept finite by gates that never overflow here).
* a numpy model of the kernel's passes, step by step: the gate scalars,
  [C | n] at every chunk start walked in order, P on and below the
  diagonal in 64 x 64 tiles, [num | den] reduced to per-row partials per
  64-column tile, the denominator's branch per position, G = [dh / M |
  dden], dS and the column partials of D o P per 64-row tile, d[C | n]
  walked in reverse with <dCn, [C | n]> per state tile, dq, dk (with its
  partials of k . state term per dk tile) and dv, and the gates' backward
  (da, the m chain into each chunk's last F, the reverse cumsum of dF, log
  sigmoid').  The stabilisers g are held constant, positions past S in the
  last chunk are masked, every sum over tiles runs in the kernel's order.
  It must equal autograd of the plain version (float32 model, float32
  autograd: max |model - autograd| <= 1e-4 x max |autograd|), in both
  branches of max(|den|, e^{-m}).
  That model is the CUDA-core route's (float32, and bf16 at widths the
  tensor cores do not take); its gate passes run a warp per chunk now, which
  reorders sums the model takes in order.
* a model of the tensor-core route's pass structure (bf16): chunk-parallel
  gates (in-chunk cumsum and cummax, m carried in order over the chunks'
  last F and cummax); [C | n] at chunk starts from k^T (u [v | 1]); per
  64-row tile, P recomputed, [num | den] = [P | sigma q'] [[v | 1] ; [C |
  n]] reduced to dh . num and den, the branch, D = G [v | 1]^T with the
  column sums of D o P, dS, and dq = [dS | sigma G] [k ; [C | n]^T]; d[C |
  n] walked in reverse from (sigma q')^T G with <d[C | n]_prev, [C | n]_prev>
  for dm (the state enters a chunk only as e^{m_prev} [C | n]_prev); per
  64-column tile, P^T and dS^T recomputed, dv = [P^T | u k] [G ; dC] and dk
  = [dS^T | u [v | 1]] [q' ; dCn^T] with k . (its state term) for da; the
  gates' backward.  No P or dS leaves its tile.  Unrounded it equals
  autograd as the first model does; with every mma operand rounded to
  bf16 (the states too, kept float32 between products) on bf16 inputs it
  is within the card's bf16 limit, SCAN_GRAD_TOL (0.5 of the plain
  gradient's RMS); ragged tails included.
* the autograd route: ``_MLSTM`` with its two launches swapped for plain
  versions runs the forward, then the backward, and gives the plain
  gradients; an initial state, or a loss that reaches the final state,
  raises under grad (ROADMAP item 12f).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.xlstm import mlstm_chunked as jax_mlstm_chunked
from repro_torch.kernels import mlstm

T = 64   # csrc/tile_f32.cuh kT
RTOL = 1e-4

CASES = [  # B, H, S, dk, dv, chunk, i bias, f bias
    (1, 2, 64, 16, 24, 64, 0.0, 3.0),
    (2, 1, 100, 16, 24, 64, 0.0, 3.0),      # ragged: 64 + 36 (the plain version: 2 x 50)
    (1, 2, 130, 70, 65, 64, 0.0, 0.0),      # dk, dv past a tile; three chunks
    (1, 1, 96, 16, 16, 32, -8.0, 3.0),      # small i: rows take the e^{-m} branch
    (1, 1, 200, 8, 8, 128, 0.0, 1.0),       # a chunk of two row tiles
]
IDS = ["one_chunk", "ragged", "wide", "em_branch", "two_tiles"]


def _inputs(seed, B, H, S, dk, dv, ibias, fbias):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, H, dk)).astype(np.float32)
    k = rng.standard_normal((B, S, H, dk)).astype(np.float32)
    v = rng.standard_normal((B, S, H, dv)).astype(np.float32)
    i = (rng.standard_normal((B, S, H)) + ibias).astype(np.float32)
    f = (rng.standard_normal((B, S, H)) + fbias).astype(np.float32)
    dh = rng.standard_normal((B, S, H, dv)).astype(np.float32)
    return q, k, v, i, f, dh


def _torch_grads(q, k, v, i, f, dh, chunk):
    """autograd of the plain version (divisor chunk), model layout."""
    t = lambda a: torch.from_numpy(a).transpose(1, 2)
    grads = mlstm.mlstm_chunked_heads_backward(t(q), t(k), t(v), t(i), t(f), t(dh),
                                               chunk=chunk)
    return [g.transpose(1, 2).numpy() for g in grads]


def _close(got, want, name):
    scale = np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= RTOL * scale, f"{name}: max |diff| {err:.3g} > {RTOL} x {scale:.3g}"


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plain_backward_matches_jax_vjp(case):
    B, H, S, dk, dv, chunk, ib, fb = case
    q, k, v, i, f, dh = _inputs(1, B, H, S, dk, dv, ib, fb)
    L = min(chunk, S)
    while S % L:   # the reference needs a divisor chunk
        L -= 1
    _, vjp = jax.vjp(lambda *a: jax_mlstm_chunked(*a, chunk=L)[0], q, k, v, i, f)
    want = [np.asarray(g) for g in vjp(jnp.asarray(dh))]
    got = _torch_grads(q, k, v, i, f, dh, chunk)
    for g, w, name in zip(got, want, ("dq", "dk", "dv", "di", "df")):
        _close(g, w, name)


def test_plain_backward_finite_where_the_reference_overflows():
    """The reference masks e^{a_s - g_t} after ``exp``: once an exponent
    above the diagonal overflows (forget gates far from 1 over a long
    chunk), its gradient is 0 * inf = NaN.  The port masks before ``exp``,
    so its plain gradient stays finite and equals the one a short chunk
    gives."""
    q, k, v, i, f, dh = _inputs(4, 1, 1, 128, 8, 8, 0.0, -2.0)
    _, vjp = jax.vjp(lambda *a: jax_mlstm_chunked(*a, chunk=128)[0], q, k, v, i, f)
    assert not np.isfinite(np.asarray(vjp(jnp.asarray(dh))[4])).all()
    got = _torch_grads(q, k, v, i, f, dh, 128)
    short = _torch_grads(q, k, v, i, f, dh, 16)
    for g, w, name in zip(got, short, ("dq", "dk", "dv", "di", "df")):
        assert np.isfinite(g).all()
        _close(g, w, name)


# -- the kernel's passes, in numpy ------------------------------------------------


def _logsig(x):
    return np.minimum(x, 0) - np.log1p(np.exp(-np.abs(x)))


def kernel_model(q, k, v, i, f, dh, chunk):
    """csrc/mlstm_bwd.cu for one (sequence, head), pass by pass, float32.
    q, k (S, dk), v and dh (S, dv), gates (S,).  Returns (dq, dk, dv, di,
    df) and the number of positions that took the e^{-m} branch."""
    f32 = np.float32
    S, dk = q.shape
    dv = v.shape[1]
    L = min(chunk, S)
    nc, Lp = -(-S // L), -(-L // T) * T
    W, Wp = dv + 1, -(-(dv + 1) // T) * T
    rpc, nct, dkt = Lp // T, Wp // T, -(-dk // T)
    sq = f32(math.sqrt(dk))
    nv = [min(L, S - c * L) for c in range(nc)]

    def rows(a, c):   # positions of chunk c, padded to Lp with zeros
        out = np.zeros((Lp, *a.shape[1:]), f32)
        out[:nv[c]] = a[c * L:c * L + nv[c]]
        return out

    def ext(c, scale=None):   # [v | 1] of chunk c, Wp wide
        e = np.zeros((Lp, Wp), f32)
        e[:nv[c], :dv] = v[c * L:c * L + nv[c]]
        e[:nv[c], dv] = 1
        return e if scale is None else scale[:, None] * e

    Q = [rows(q / sq, c) for c in range(nc)]
    K = [rows(k, c) for c in range(nc)]
    DH = [rows(dh, c) for c in range(nc)]
    # 1 gates
    F, a, g, sig, u = (np.zeros((nc, Lp), f32) for _ in range(5))
    tau = np.zeros(nc, f32)
    mp = f32(-np.inf)
    for c in range(nc):
        Fr, acm = f32(0), f32(-np.inf)
        for r in range(nv[c]):
            Fr = f32(Fr + _logsig(f[c * L + r]))
            a[c, r] = i[c * L + r] - Fr
            acm = max(acm, a[c, r])
            F[c, r], g[c, r] = Fr, max(mp, acm)
            sig[c, r] = np.exp(mp - g[c, r])
        gL = g[c, nv[c] - 1]
        u[c, :nv[c]] = np.exp(a[c, :nv[c]] - gL)
        tau[c] = np.exp(mp - gL)
        mp = F[c, nv[c] - 1] + gL
    # 2 [C | n] at every chunk start
    Cp = np.zeros((nc, dk, Wp), f32)
    for c in range(nc - 1):
        Cp[c + 1] = tau[c] * Cp[c] + K[c].T @ ext(c, u[c])
    valid = [np.arange(Lp) < nv[c] for c in range(nc)]
    tri = np.tril(np.ones((Lp, Lp), bool))
    # 3 P; 4 [num | den] as per-row partials per column tile
    P, Wts = [], []
    for c in range(nc):
        ok = tri & valid[c][:, None]
        wts = np.exp(np.where(ok, a[c][None, :] - g[c][:, None], -np.inf)).astype(f32)
        P.append(np.where(ok, (Q[c] @ K[c].T) * wts, 0).astype(f32))
        Wts.append(wts)
    invM, dden, dFb, dss = (np.zeros((nc, Lp), f32) for _ in range(4))
    G = np.zeros((nc, Lp, Wp), f32)
    em_rows = 0
    for c in range(nc):
        intra = P[c] @ ext(c)
        inter = sig[c][:, None] * (Q[c] @ Cp[c])
        ri = np.zeros(Lp, f32)
        re = np.zeros(Lp, f32)
        for ct in range(nct):   # the partials of the 64-column tiles, in order
            cols = slice(ct * T, min((ct + 1) * T, dv))
            if cols.start < dv:
                ri += (DH[c][:, cols] * intra[:, cols]).sum(1)
                re += (DH[c][:, cols] * inter[:, cols]).sum(1)
        # 5 the branch
        den = intra[:, dv] + inter[:, dv]
        em = np.exp(-(F[c] + g[c]))
        by_den = np.abs(den) >= em
        M = np.where(by_den, np.abs(den), em)
        rho = ri + re
        inv = np.where(valid[c], 1 / M, 0).astype(f32)
        invM[c] = inv
        dden[c] = np.where(by_den & valid[c], -np.sign(den) * rho * inv * inv, 0)
        dFb[c] = np.where(by_den | ~valid[c], 0, rho * inv)
        dss[c] = inv * re + dden[c] * inter[:, dv]
        em_rows += int((~by_den & valid[c]).sum())
        # 6 G
        G[c, :, :dv] = inv[:, None] * DH[c]
        G[c, :, dv] = dden[c]
    # 7 dS and the column partials of D o P per 64-row tile
    dS, colpart = [], np.zeros((nc, rpc, Lp), f32)
    for c in range(nc):
        D = G[c] @ ext(c).T
        ok = tri & valid[c][:, None]
        dS.append(np.where(ok, D * Wts[c], 0).astype(f32))
        DP = np.where(ok, D * P[c], 0)
        for tt in range(rpc):
            colpart[c, tt] = DP[tt * T:(tt + 1) * T].sum(0)
    # 8 d[C | n] at every chunk end, in reverse; <dCn, [C | n]> per chunk
    dCn = np.zeros((nc, dk, Wp), f32)
    dot = np.zeros(nc, f32)
    acc = np.zeros((dk, Wp), f32)
    for c in reversed(range(nc)):
        dCn[c] = acc
        dot[c] = (acc * Cp[c]).sum()
        acc = tau[c] * acc + (sig[c][:, None] * Q[c]).T @ G[c]
    # 9-11 dq, dk, dv
    dq, dkk, dvv = np.zeros((S, dk), f32), np.zeros((S, dk), f32), np.zeros((S, dv), f32)
    dkpart = np.zeros((nc, Lp, dkt), f32)
    for c in range(nc):
        n, s = nv[c], slice(c * L, c * L + nv[c])
        dq[s] = ((dS[c] @ K[c] + sig[c][:, None] * (G[c] @ Cp[c].T)) / sq)[:n]
        inter = u[c][:, None] * (ext(c) @ dCn[c].T)
        dkk[s] = (dS[c].T @ Q[c] + inter)[:n]
        for jt in range(dkt):
            js = slice(jt * T, (jt + 1) * T)
            dkpart[c, :, jt] = (K[c][:, js] * inter[:, js]).sum(1)
        dvv[s] = (P[c].T @ (invM[c][:, None] * DH[c]) + u[c][:, None] * (K[c] @ dCn[c][:, :dv]))[:n]
    # 12 gates
    di, df = np.zeros(S, f32), np.zeros(S, f32)
    dm_next = f32(0)
    for c in reversed(range(nc)):
        dls = f32(0)
        for r in reversed(range(nv[c])):
            da = colpart[c, r // T:, r].sum() + dkpart[c, r].sum()
            dF = dFb[c, r] - da + (dm_next if r == L - 1 else 0)
            dls = f32(dls + dF)
            df[c * L + r] = dls / (1 + np.exp(f[c * L + r]))
            di[c * L + r] = da
        dm_next = dss[c, :nv[c]].sum() + tau[c] * dot[c]
    return (dq, dkk, dvv, di, df), em_rows


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_kernel_model_matches_autograd(case):
    B, H, S, dk, dv, chunk, ib, fb = case
    q, k, v, i, f, dh = _inputs(2, B, H, S, dk, dv, ib, fb)
    want = _torch_grads(q, k, v, i, f, dh, chunk)
    em_rows = 0
    for b in range(B):
        for h in range(H):
            got, n = kernel_model(q[b, :, h], k[b, :, h], v[b, :, h], i[b, :, h], f[b, :, h],
                                  dh[b, :, h], chunk)
            em_rows += n
            for g, w, name in zip(got, (x[b, :, h] for x in want), ("dq", "dk", "dv", "di", "df")):
                _close(g, w, name)
    if ib < 0:
        assert em_rows > 0, "no position took the e^{-m} branch"


# -- the tensor-core route's passes ----------------------------------------------


def _bf16(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(torch.bfloat16).float().numpy()


def tc_model(q, k, v, i, f, dh, chunk, rounded):
    """csrc/mlstm_bwd.cu's tensor-core route for one (sequence, head), pass
    by pass, float32; ``rounded``: every product's operands rounded to bf16
    (q' = q / sqrt(dk) rounded first, as the plain version rounds it)."""
    f32 = np.float32
    S, dk = q.shape
    dv = v.shape[1]
    L = min(chunk, S)
    nc, Lp = -(-S // L), -(-L // T) * T
    op = _bf16 if rounded else (lambda a: a.astype(f32))
    nv = [min(L, S - c * L) for c in range(nc)]
    sq = f32(math.sqrt(dk))
    qs = _bf16(q / sq) if rounded else q / sq

    def rows(a, c):   # positions of chunk c, padded to Lp with zeros
        out = np.zeros((Lp, *a.shape[1:]), f32)
        out[:nv[c]] = a[c * L:c * L + nv[c]]
        return out

    def ext(c):       # [v | 1] of chunk c, dv + 1 wide
        e = np.zeros((Lp, dv + 1), f32)
        e[:nv[c], :dv] = v[c * L:c * L + nv[c]]
        e[:nv[c], dv] = 1
        return e

    Q, K, DH = ([rows(a, c) for c in range(nc)] for a in (qs, k, dh))
    # 1a a warp per chunk: in-chunk cumsum and cummax; 1b m carried in order
    F, a, cm = (np.zeros((nc, Lp), f32) for _ in range(3))
    last = []
    for c in range(nc):
        n = nv[c]
        F[c, :n] = np.cumsum(_logsig(f[c * L:c * L + n]), dtype=f32)
        a[c, :n] = i[c * L:c * L + n] - F[c, :n]
        cm[c, :n] = np.maximum.accumulate(a[c, :n])
        last.append((F[c, n - 1], cm[c, n - 1]))
    g, sig, u = (np.zeros((nc, Lp), f32) for _ in range(3))
    tau = np.zeros(nc, f32)
    for c in range(nc):
        mp = f32(-np.inf)
        for Fl, ml in last[:c]:
            mp = Fl + max(mp, ml)
        gL = max(mp, last[c][1])
        n = nv[c]
        g[c, :n] = np.maximum(mp, cm[c, :n])
        sig[c, :n] = np.exp(mp - g[c, :n])
        u[c, :n] = np.exp(a[c, :n] - gL)
        tau[c] = np.exp(mp - gL)
    valid = [np.arange(Lp) < nv[c] for c in range(nc)]
    tri = np.tril(np.ones((Lp, Lp), bool))
    Wt = []
    for c in range(nc):
        ok = tri & valid[c][:, None]
        Wt.append(np.exp(np.where(ok, a[c][None, :] - g[c][:, None], -np.inf)).astype(f32))
    # 2 [C | n] at every chunk start, float32 between products
    Cp = np.zeros((nc, dk, dv + 1), f32)
    for c in range(nc - 1):
        Cp[c + 1] = tau[c] * Cp[c] + op(K[c]).T @ op(u[c][:, None] * ext(c))
    # 3 the row pass: P, [num | den], the branch, D, dS, dq
    invM, dden, dFb = (np.zeros((nc, Lp), f32) for _ in range(3))
    G, dS, colsum = [], [], np.zeros((nc, Lp), f32)
    dq = np.zeros((S, dk), f32)
    for c in range(nc):
        P = op((Q[c] @ K[c].T) * Wt[c])   # rows t, columns s: a bf16 tile in shared memory
        num = op(P) @ op(ext(c)) + op(sig[c][:, None] * Q[c]) @ op(Cp[c])
        rho = (DH[c] * num[:, :dv]).sum(1)
        den = num[:, dv]
        em = np.exp(-(F[c] + g[c]))
        by_den = np.abs(den) >= em
        inv = np.where(valid[c], 1 / np.where(by_den, np.abs(den), em), 0).astype(f32)
        invM[c] = inv
        dden[c] = np.where(by_den & valid[c], -np.sign(den) * rho * inv * inv, 0)
        dFb[c] = np.where(by_den | ~valid[c], 0, rho * inv)
        Gc = np.concatenate([inv[:, None] * DH[c], dden[c][:, None]], 1).astype(f32)
        D = op(Gc) @ op(ext(c)).T
        colsum[c] = (D * P).sum(0)
        dS.append(op(D * Wt[c]))
        G.append(Gc)
        n, s = nv[c], slice(c * L, c * L + nv[c])
        dq[s] = ((dS[c] @ op(K[c]) + op(sig[c][:, None] * Gc) @ op(Cp[c]).T) / sq)[:n]
    # 4 d[C | n] at every chunk end, in reverse; <d[C | n]_prev, [C | n]_prev>
    dCn = np.zeros((nc, dk, dv + 1), f32)
    dot = np.zeros(nc, f32)
    acc = np.zeros((dk, dv + 1), f32)
    for c in reversed(range(nc)):
        dCn[c] = acc
        if c == 0:
            break
        acc = tau[c] * acc + op(sig[c][:, None] * Q[c]).T @ op(G[c])
        dot[c] = (acc * Cp[c]).sum()
    # 5 the column pass: P^T, dS^T (the same tiles, transposed), dv, dk
    dk_, dv_ = np.zeros((S, dk), f32), np.zeros((S, dv), f32)
    da = np.zeros((nc, Lp), f32)
    for c in range(nc):
        n, s = nv[c], slice(c * L, c * L + nv[c])
        PT = op((K[c] @ Q[c].T) * Wt[c].T)
        dv_[s] = (PT @ op(G[c][:, :dv]) + op(u[c][:, None] * K[c]) @ op(dCn[c][:, :dv]))[:n]
        inter = op(u[c][:, None] * ext(c)) @ op(dCn[c]).T
        dk_[s] = (dS[c].T @ Q[c] + inter)[:n]
        da[c] = colsum[c] + (K[c] * inter).sum(1)
    # 6 the gates' backward, a warp per chunk
    di, df = np.zeros(S, f32), np.zeros(S, f32)
    for c in range(nc):
        n = nv[c]
        dmn = dot[c + 1] if c + 1 < nc else f32(0)
        dF = dFb[c, :n] - da[c, :n]
        if n == L:
            dF[L - 1] += dmn
        dls = np.cumsum(dF[::-1])[::-1]
        df[c * L:c * L + n] = dls / (1 + np.exp(f[c * L:c * L + n]))
        di[c * L:c * L + n] = da[c, :n]
    return dq, dk_, dv_, di, df


SCAN_GRAD_TOL_BF16 = 0.5   # chip_smoke.py SCAN_GRAD_TOL["bfloat16"]


@pytest.mark.parametrize("rounded", [False, True], ids=["float32", "bf16_operands"])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_tensor_core_route_model_matches_autograd(case, rounded):
    B, H, S, dk, dv, chunk, ib, fb = case
    q, k, v, i, f, dh = _inputs(6, B, H, S, dk, dv, ib, fb)
    if rounded:
        # the kernel's bf16 inputs, q and k |N(0, 1)| as the card's checks
        # draw them: with signed q . k a denominator can pass through 0, and
        # there one bf16 rounding of any operand moves 1/M by any amount
        q, k = np.abs(q), np.abs(k)
        q, k, v, i, f, dh = (_bf16(x) for x in (q, k, v, i, f, dh))
    want = _torch_grads(q, k, v, i, f, dh, chunk)
    for b in range(B):
        for h in range(H):
            got = tc_model(q[b, :, h], k[b, :, h], v[b, :, h], i[b, :, h], f[b, :, h],
                           dh[b, :, h], chunk, rounded)
            for gg, w, name in zip(got, (x[b, :, h] for x in want), ("dq", "dk", "dv", "di", "df")):
                if not rounded:
                    _close(gg, w, name)
                    continue
                err = np.abs(gg - w).max() / np.sqrt(np.mean(w ** 2))
                assert err <= SCAN_GRAD_TOL_BF16, f"{name}: max err / rms {err:.3g}"


@pytest.mark.parametrize("dtype, dk, dv, S, chunk, want", [
    (torch.bfloat16, 512, 1024, 2048, 256, "tensor_cores"),   # xlstm-1.3b's training step
    (torch.bfloat16, 512, 1024, 509, 256, "tensor_cores"),    # a ragged tail
    (torch.bfloat16, 16, 24, 100, 64, "tensor_cores"),
    (torch.float32, 512, 1024, 2048, 256, "cuda_cores"),      # float32 keeps its exact products
    (torch.bfloat16, 70, 64, 130, 64, "cuda_cores"),          # dk no multiple of 8
    (torch.bfloat16, 64, 65, 130, 64, "cuda_cores"),          # dv no multiple of 8
    (torch.bfloat16, 64, 64, 4096, 2048, "cuda_cores"),       # a 64 x L tile past shared memory
])
def test_backward_route(dtype, dk, dv, S, chunk, want):
    """``backward_route`` names the route csrc/mlstm_bwd.cu takes
    (``tc_route``: bf16, dk and dv multiples of 8, L <= 1536); the launch
    holds the kernel's own answer to it."""
    q = torch.empty(1, 1, S, dk, dtype=dtype, device="meta")
    v = torch.empty(1, 1, S, dv, dtype=dtype, device="meta")
    assert mlstm.backward_route(q, v, chunk) == want


# -- the autograd route ------------------------------------------------------------


def _plain_launches(monkeypatch):
    calls = []

    def fwd(q, k, v, i_pre, f_pre, state, chunk, out, kernel=None):
        calls.append("fwd")
        h, st = mlstm.mlstm_chunked_heads_plain(q, k, v, i_pre, f_pre, state, chunk=chunk)
        return (h if out is None else out.copy_(h)), st

    def bwd(q, k, v, i_pre, f_pre, dh, chunk):
        calls.append("bwd")
        return mlstm.mlstm_chunked_heads_backward_plain(q, k, v, i_pre, f_pre, dh, chunk=chunk)

    monkeypatch.setattr(mlstm, "_launch", fwd)
    monkeypatch.setattr(mlstm, "_launch_backward", bwd)
    return calls


def _leaves(seed=3, B=1, H=2, S=40, dk=8, dv=12):
    q, k, v, i, f, dh = _inputs(seed, B, H, S, dk, dv, 0.0, 2.0)
    t = lambda a: torch.from_numpy(a).transpose(1, 2).requires_grad_(True)
    return [t(a) for a in (q, k, v, i, f)], torch.from_numpy(dh).transpose(1, 2)


def test_function_runs_forward_then_backward(monkeypatch):
    calls = _plain_launches(monkeypatch)
    leaves, dh = _leaves()
    h, C, n, m = mlstm._MLSTM.apply(*leaves, 16)
    assert h.shape == dh.shape and h.transpose(1, 2).is_contiguous()
    (h * dh).sum().backward()
    assert calls == ["fwd", "bwd"]
    want = mlstm.mlstm_chunked_heads_backward_plain(*leaves, dh, chunk=16)
    for leaf, w in zip(leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), w.numpy(), atol=1e-6, rtol=1e-6)


def test_final_state_gradient_raises(monkeypatch):
    _plain_launches(monkeypatch)
    leaves, dh = _leaves()
    h, C, n, m = mlstm._MLSTM.apply(*leaves, 16)
    with pytest.raises(NotImplementedError, match="item 12f"):
        ((h * dh).sum() + C.sum()).backward()


def test_initial_state_raises_under_grad():
    qk = torch.empty(1, 2, 16, 8, device="meta").requires_grad_(True)
    v = torch.empty(1, 2, 16, 8, device="meta")
    gates = torch.empty(1, 2, 16, device="meta")
    state = (torch.empty(1, 2, 8, 8, device="meta"), torch.empty(1, 2, 8, device="meta"),
             torch.empty(1, 2, device="meta"))
    before = (mlstm.launches, mlstm.launches_backward)
    with pytest.raises(NotImplementedError, match="item 12f"):
        mlstm.mlstm_chunked_heads(qk, qk, v, gates, gates, state, chunk=8)
    assert (mlstm.launches, mlstm.launches_backward) == before
