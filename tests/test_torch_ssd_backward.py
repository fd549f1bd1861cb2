"""The SSD backward (``repro_torch/kernels/csrc/mamba2_ssd_bwd.cu``), on the CPU.

* ``ssd_chunked_backward_plain`` (autograd through the plain chunked form)
  against ``jax.vjp`` of the reference's ``ssd_chunked``
  (``repro/models/mamba2.py:25``) on the same numpy-seeded inputs and
  cotangent; float32, max |torch - jax| <= 1e-4 x max |jax| per gradient
  (both sum the same float32 products in other orders; decays that never
  overflow the reference's ``exp`` above the diagonal).
* a numpy model of the CUDA-core route's passes, step by step: the gate
  pass per chunk (Lc, e^{Lc} and w per position, dt = 0 past S); h at
  every chunk start walked in order and dh
  at every chunk end in reverse, with <dh_next, h_prev>; C B^T once per
  (sequence, group, chunk); per head the tiles dM = dy x^T, M and dCB on and
  below the diagonal with the row and column partials of dM o M and dM o
  CB o decay per 64-position tile; dC, dB (with dw = B . (dh x)) and dx;
  the gates' backward per chunk (d Lc, d LL at the chunk's last position,
  the reverse cumsum, ddt, the chunk's dA and dD) and the sums over each
  group's heads and over sequences and chunks in order.  It must equal
  autograd of the plain version (float32: max |model - autograd| <= 1e-4
  x max |autograd|).
* a numpy model of the tensor-core route's passes (bf16):
  per-chunk gates; h and dh walked with the states stored as the bf16
  operands the products read; a row pass per (64-position t tile, head
  block) that forms C B^T once for the block's heads, then per head e^{Lc}
  dy h_prev^T and, per s tile, dM, the row sums of dM o M and dCB into a
  tile that dC += dCB B reads at once; a column pass per s tile that
  forms B C^T once, then per head the state terms (dw), and per t tile
  dM^T, ddt's causal term, M^T and dCB^T into tiles that dx and dB read at
  once; dB and dC summed over a head block's heads, then over the head
  blocks in order.  No M or dCB outside its tile.  Unrounded it equals
  autograd to 1e-4; with every mma operand rounded to bf16 on bf16 inputs
  it is within the card's bf16 limit (0.5 of the plain gradient's RMS).
* the autograd route: ``_SSD`` with its two launches swapped for plain
  versions runs the forward, then the backward, and gives the plain
  gradients; an initial state, or a loss that reaches the final state,
  raises under grad (ROADMAP item 12f).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.mamba2 import ssd_chunked as jax_ssd_chunked
from repro_torch.kernels import mamba2_ssd as ssd

T = 64   # csrc/tile_f32.cuh kT
RTOL = 1e-4
NAMES = ("dx", "ddt", "dA", "dB", "dC", "dD")

CASES = [  # B, S, H, G, N, P, chunk
    (1, 64, 4, 2, 8, 8, 32),
    (2, 100, 2, 1, 8, 8, 64),      # ragged: 64 + 36 (the plain version: 2 x 50)
    (1, 150, 2, 1, 70, 66, 64),    # N, P past a tile; three chunks
    (1, 200, 4, 1, 8, 8, 128),     # a chunk of two row tiles, 4 heads a group
]
IDS = ["groups", "ragged", "wide", "two_tiles"]


def _inputs(seed, B, S, H, G, N, P, dt_max=0.2):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dt = rng.uniform(0.01, dt_max, (B, S, H)).astype(np.float32)
    A = -rng.uniform(1.0, 4.0, H).astype(np.float32)
    Bm = rng.standard_normal((B, S, G, N)).astype(np.float32)
    Cm = rng.standard_normal((B, S, G, N)).astype(np.float32)
    D = rng.uniform(0.5, 1.5, H).astype(np.float32)
    dy = rng.standard_normal((B, S, H, P)).astype(np.float32)
    return x, dt, A, Bm, Cm, D, dy


def _torch_grads(x, dt, A, Bm, Cm, D, dy, chunk):
    t = torch.from_numpy
    grads = ssd.ssd_chunked_backward(t(x), t(dt), t(A), t(Bm), t(Cm), t(D), t(dy), chunk=chunk)
    return [g.numpy() for g in grads]


def _close(got, want, name):
    scale = np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= RTOL * scale, f"{name}: max |diff| {err:.3g} > {RTOL} x {scale:.3g}"


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plain_backward_matches_jax_vjp(case):
    B, S, H, G, N, P, chunk = case
    x, dt, A, Bm, Cm, D, dy = _inputs(1, B, S, H, G, N, P)
    L = min(chunk, S)
    while S % L:   # the reference needs a divisor chunk
        L -= 1
    _, vjp = jax.vjp(lambda *a: jax_ssd_chunked(*a, chunk=L)[0], x, dt, A, Bm, Cm, D)
    want = [np.asarray(g) for g in vjp(jnp.asarray(dy))]
    got = _torch_grads(x, dt, A, Bm, Cm, D, dy, chunk)
    for g, w, name in zip(got, want, NAMES):
        _close(g, w, name)


def test_plain_backward_finite_where_the_reference_overflows():
    """The reference masks e^{Lc_t - Lc_s} after ``exp``: once an exponent
    above the diagonal overflows (zamba2's A up to -16 and dt up to ~0.5
    over a chunk of 128), its dt gradient is 0 * inf = NaN.  The port masks
    before ``exp``: its gradient stays finite and equals a short chunk's."""
    x, dt, A, Bm, Cm, D, dy = _inputs(5, 1, 128, 2, 1, 8, 8, dt_max=0.6)
    A = np.array([-16.0, -8.0], np.float32)
    _, vjp = jax.vjp(lambda *a: jax_ssd_chunked(*a, chunk=128)[0], x, dt, A, Bm, Cm, D)
    assert not np.isfinite(np.asarray(vjp(jnp.asarray(dy))[1])).all()
    got = _torch_grads(x, dt, A, Bm, Cm, D, dy, 128)
    short = _torch_grads(x, dt, A, Bm, Cm, D, dy, 16)
    for g, w, name in zip(got, short, NAMES):
        assert np.isfinite(g).all()
        _close(g, w, name)


# -- the kernel's passes, in numpy ------------------------------------------------


def kernel_model(x, dt, A, Bm, Cm, D, dy, chunk):
    """csrc/mamba2_ssd_bwd.cu, pass by pass, float32, in the model layout."""
    f32 = np.float32
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2:]
    hpg = H // G
    L = min(chunk, S)
    nc, Lp = -(-S // L), -(-L // T) * T
    rpc = Lp // T
    nv = [min(L, S - c * L) for c in range(nc)]
    tri = np.tril(np.ones((Lp, Lp), bool))

    def rows(a, c):   # positions of chunk c, padded to Lp with zeros
        out = np.zeros((Lp, *a.shape[1:]), f32)
        out[:nv[c]] = a[c * L:c * L + nv[c]]
        return out

    dx = np.zeros_like(x)
    ddt = np.zeros_like(dt)
    dBh = np.zeros((Bsz, S, H, N), f32)
    dCh = np.zeros((Bsz, S, H, N), f32)
    dAc, dDc = np.zeros((Bsz, H, nc), f32), np.zeros((Bsz, H, nc), f32)
    for b in range(Bsz):
        # 4 C B^T per group and chunk
        CB = [[rows(Cm[b, :, g], c) @ rows(Bm[b, :, g], c).T for c in range(nc)]
              for g in range(G)]
        for h in range(H):
            g = h // hpg
            X = [rows(x[b, :, h], c) for c in range(nc)]
            DY = [rows(dy[b, :, h], c) for c in range(nc)]
            Bc = [rows(Bm[b, :, g], c) for c in range(nc)]
            Cc = [rows(Cm[b, :, g], c) for c in range(nc)]
            DT = [rows(dt[b, :, h], c) for c in range(nc)]
            # 1 gates, a warp per chunk
            Lc = [np.cumsum(A[h] * DT[c]).astype(f32) for c in range(nc)]
            E = [np.exp(l) for l in Lc]
            dec = [np.exp(l[-1] - l) for l in Lc]
            w = [dec[c] * DT[c] for c in range(nc)]
            eLL = [np.exp(l[-1]) for l in Lc]
            # 2 h at every chunk start; 3 dh at every chunk end, <dh, h>
            hp = [np.zeros((N, P), f32)]
            for c in range(nc - 1):
                hp.append(eLL[c] * hp[c] + (w[c][:, None] * Bc[c]).T @ X[c])
            dhn, dot = [None] * nc, np.zeros(nc, f32)
            acc = np.zeros((N, P), f32)
            for c in reversed(range(nc)):
                dhn[c] = acc
                dot[c] = (acc * hp[c]).sum()
                acc = eLL[c] * acc + (E[c][:, None] * Cc[c]).T @ DY[c]
            for c in range(nc):
                n = nv[c]
                ok = tri & (np.arange(Lp) < n)[:, None]
                # 5 dM, M, dCB and the partials per 64-position tile
                dM = DY[c] @ X[c].T
                decay = np.exp(np.where(ok, Lc[c][:, None] - Lc[c][None, :], -np.inf))
                M = np.where(ok, CB[g][c] * decay * DT[c][None, :], 0).astype(f32)
                dCB = np.where(ok, dM * decay * DT[c][None, :], 0).astype(f32)
                dMM = np.where(ok, dM * M, 0)
                dMC = np.where(ok, dM * CB[g][c] * decay, 0)
                rowpart = np.stack([dMM[:, st * T:(st + 1) * T].sum(1) for st in range(rpc)], 1)
                colpart = np.stack([dMM[tt * T:(tt + 1) * T].sum(0) for tt in range(rpc)], 1)
                ddtpart = np.stack([dMC[tt * T:(tt + 1) * T].sum(0) for tt in range(rpc)], 1)
                # 6-8 dC, dB (and dw), dx
                yh = DY[c] @ hp[c].T
                dC = dCB @ Bc[c] + E[c][:, None] * yh
                eps = (Cc[c] * E[c][:, None] * yh).sum(1)
                hx = X[c] @ dhn[c].T
                dB = dCB.T @ Cc[c] + w[c][:, None] * hx
                dw = (Bc[c] * hx).sum(1)
                dxc = M.T @ DY[c] + w[c][:, None] * (Bc[c] @ dhn[c]) + D[h] * DY[c]
                s = slice(c * L, c * L + n)
                dCh[b, s, h], dBh[b, s, h], dx[b, s, h] = dC[:n], dB[:n], dxc[:n]
                dDc[b, h, c] = sum((X[c][st * T:(st + 1) * T] * DY[c][st * T:(st + 1) * T]).sum()
                                   for st in range(-(-n // T)))
                # 2 gates_bwd, a warp per chunk: d Lc, its reverse cumsum, ddt
                dLL = eLL[c] * dot[c] + (w[c][:n] * dw[:n]).sum()
                dll = f32(0)
                for r in reversed(range(n)):
                    dLc = (rowpart[r, :r // T + 1].sum() + eps[r] - colpart[r, r // T:].sum()
                           - w[c][r] * dw[r] + (dLL if r == n - 1 else 0))
                    dll = f32(dll + dLc)
                    ddt[b, c * L + r, h] = ddtpart[r, r // T:].sum() + dec[c][r] * dw[r] + A[h] * dll
                    dAc[b, h, c] += DT[c][r] * dll
    # 3 sums over each group's heads, and over the sequences and chunks, in order
    dBm = np.stack([dBh[:, :, g * hpg:(g + 1) * hpg].sum(2) for g in range(G)], 2)
    dCm = np.stack([dCh[:, :, g * hpg:(g + 1) * hpg].sum(2) for g in range(G)], 2)
    return dx, ddt, dAc.sum((0, 2)), dBm, dCm, dDc.sum((0, 2))


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_kernel_model_matches_autograd(case):
    B, S, H, G, N, P, chunk = case
    args = _inputs(2, B, S, H, G, N, P, dt_max=0.5)
    want = _torch_grads(*args, chunk)
    got = kernel_model(*args, chunk)
    for g, w, name in zip(got, want, NAMES):
        _close(g, w, name)


# -- the tensor-core route's passes ----------------------------------------------


def _bf16(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(torch.bfloat16).float().numpy()


def tc_model(x, dt, A, Bm, Cm, D, dy, chunk, rounded, heads_per_block):
    """csrc/mamba2_ssd_bwd.cu's tensor-core route, pass by pass, float32;
    ``rounded``: every mma operand rounded to bf16 where the kernel rounds
    it (w B and e^{Lc} C in the walks, the stored h and dh, C B^T, dCB, M^T
    and dCB^T tiles); ``heads_per_block``: the row and column passes' head
    blocks."""
    f32 = np.float32
    op = _bf16 if rounded else (lambda a: np.asarray(a, f32))
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2:]
    hpg = H // G
    L = min(chunk, S)
    nc, Lp = -(-S // L), -(-L // T) * T
    rpc = Lp // T
    nv = [min(L, S - c * L) for c in range(nc)]
    heads = [list(range(g * hpg + h0, min(g * hpg + h0 + heads_per_block, (g + 1) * hpg)))
             for g in range(G) for h0 in range(0, hpg, heads_per_block)]

    def rows(a, c):   # positions of chunk c, padded to Lp with zeros
        out = np.zeros((Lp, *a.shape[1:]), f32)
        out[:nv[c]] = a[c * L:c * L + nv[c]]
        return out

    X = [[[rows(x[b, :, h], c) for c in range(nc)] for h in range(H)] for b in range(Bsz)]
    DY = [[[rows(dy[b, :, h], c) for c in range(nc)] for h in range(H)] for b in range(Bsz)]
    Bc = [[[rows(Bm[b, :, g], c) for c in range(nc)] for g in range(G)] for b in range(Bsz)]
    Cc = [[[rows(Cm[b, :, g], c) for c in range(nc)] for g in range(G)] for b in range(Bsz)]
    # 1 gates, per (sequence, head, chunk)
    DT = [[[rows(dt[b, :, h], c) for c in range(nc)] for h in range(H)] for b in range(Bsz)]
    Lc = [[[np.cumsum(A[h] * DT[b][h][c]).astype(f32) for c in range(nc)] for h in range(H)]
          for b in range(Bsz)]
    E = [[[np.exp(l) for l in Lc[b][h]] for h in range(H)] for b in range(Bsz)]
    dec = [[[np.exp(l[-1] - l) for l in Lc[b][h]] for h in range(H)] for b in range(Bsz)]
    W = [[[dec[b][h][c] * DT[b][h][c] for c in range(nc)] for h in range(H)] for b in range(Bsz)]
    eLL = [[[np.exp(l[-1]) for l in Lc[b][h]] for h in range(H)] for b in range(Bsz)]
    # a, b: the walks, the states stored as bf16 operands
    hp, dhn, dot = {}, {}, {}
    for b in range(Bsz):
        for h in range(H):
            g = h // hpg
            acc = np.zeros((N, P), f32)
            for c in range(nc):
                hp[b, h, c] = op(acc)
                acc = eLL[b][h][c] * acc + op(W[b][h][c][:, None] * Bc[b][g][c]).T @ X[b][h][c]
            acc = np.zeros((N, P), f32)
            for c in reversed(range(nc)):
                dhn[b, h, c] = op(acc)
                dot[b, h, c] = (acc * hp[b, h, c]).sum()
                acc = eLL[b][h][c] * acc + op(E[b][h][c][:, None] * Cc[b][g][c]).T @ DY[b][h][c]
    rowsum, eps, ddtc, dw = (np.zeros((Bsz, H, nc, Lp), f32) for _ in range(4))
    dDpart = np.zeros((Bsz, H, nc, rpc), f32)
    dx = np.zeros_like(x)
    dBp = np.zeros((len(heads) // G, Bsz, S, G, N), f32)
    dCp = np.zeros_like(dBp)
    tri = np.tril(np.ones((T, T), bool))
    for b in range(Bsz):
        for c in range(nc):
            n = nv[c]
            s_ = slice(c * L, c * L + n)
            for blk, hs in enumerate(heads):
                g, hb = hs[0] // hpg, blk % (len(heads) // G)
                Bg, Cg = Bc[b][g][c], Cc[b][g][c]
                for i in range(-(-n // T)):   # c: the row pass of t tile i
                    ti = slice(i * T, (i + 1) * T)
                    t_ok = (np.arange(i * T, (i + 1) * T) < n)[:, None]
                    CB = [op(Cg[ti] @ Bg[st * T:(st + 1) * T].T) for st in range(i + 1)]
                    dc = np.zeros((T, N), f32)
                    for h in hs:
                        lc, dts = Lc[b][h][c], DT[b][h][c]
                        if c > 0:
                            inter = (DY[b][h][c][ti] @ hp[b, h, c].T) * E[b][h][c][ti, None]
                            eps[b, h, c, ti] = (Cg[ti] * inter).sum(1)
                            dc += inter
                        for st in range(i + 1):
                            si = slice(st * T, (st + 1) * T)
                            dm = DY[b][h][c][ti] @ X[b][h][c][si].T
                            ok = t_ok & (tri if st == i else True)
                            dd = np.exp(np.where(ok, lc[ti, None] - lc[None, si], 0))
                            dd = dd * dts[None, si]
                            rowsum[b, h, c, ti] += np.where(ok, dm * CB[st] * dd, 0).sum(1)
                            dc += op(np.where(ok, dm * dd, 0)) @ Bg[si]
                    m = min(T, n - i * T)
                    dCp[hb, b, c * L + i * T:c * L + i * T + m, g] = dc[:m]
                for i in range(-(-n // T)):   # d: the column pass of s tile i
                    si = slice(i * T, (i + 1) * T)
                    tend = -(-n // T)
                    CBt = {tt: op(Bg[si] @ Cg[tt * T:(tt + 1) * T].T) for tt in range(i, tend)}
                    db = np.zeros((T, N), f32)
                    for h in hs:
                        lc, dts, w = Lc[b][h][c], DT[b][h][c], W[b][h][c]
                        dxs = np.zeros((T, P), f32)
                        if c < nc - 1:
                            a = X[b][h][c][si] @ dhn[b, h, c].T
                            dw[b, h, c, si] = (Bg[si] * a).sum(1)
                            db += w[si, None] * a
                            dxs = w[si, None] * (Bg[si] @ dhn[b, h, c])
                        for tt in range(i, tend):
                            ti = slice(tt * T, (tt + 1) * T)
                            dmt = X[b][h][c][si] @ DY[b][h][c][ti].T
                            ok = (np.arange(tt * T, (tt + 1) * T) < n)[None, :] & (
                                tri.T if tt == i else True)
                            de = np.exp(np.where(ok, lc[None, ti] - lc[si, None], 0))
                            q = np.where(ok, CBt[tt] * de, 0)
                            ddtc[b, h, c, si] += (dmt * q).sum(1)
                            dxs += op(q * dts[si, None]) @ DY[b][h][c][ti]
                            db += op(np.where(ok, dmt * de * dts[si, None], 0)) @ Cg[ti]
                        dxs += D[h] * DY[b][h][c][si]
                        m = min(T, n - i * T)
                        dx[b, c * L + i * T:c * L + i * T + m, h] = dxs[:m]
                        dDpart[b, h, c, i] = (X[b][h][c][si] * DY[b][h][c][si]).sum()
                    dBp[hb, b, c * L + i * T:c * L + i * T + m, g] = db[:m]
    # 2 gates_bwd per chunk, 3 reduce
    ddt = np.zeros_like(dt)
    dAc, dDc = np.zeros((Bsz, H, nc), f32), np.zeros((Bsz, H, nc), f32)
    for b in range(Bsz):
        for h in range(H):
            for c in range(nc):
                n, w = nv[c], W[b][h][c]
                dLL = eLL[b][h][c] * dot[b, h, c] + (w[:n] * dw[b, h, c, :n]).sum()
                xs = (rowsum[b, h, c, :n] + eps[b, h, c, :n] - DT[b][h][c][:n] * ddtc[b, h, c, :n]
                      - w[:n] * dw[b, h, c, :n])
                xs[n - 1] += dLL
                dll = np.cumsum(xs[::-1])[::-1]
                ddt[b, c * L:c * L + n, h] = (ddtc[b, h, c, :n] + dec[b][h][c][:n] * dw[b, h, c, :n]
                                              + A[h] * dll)
                dAc[b, h, c] = (DT[b][h][c][:n] * dll).sum()
                dDc[b, h, c] = dDpart[b, h, c, :-(-n // T)].sum()
    return dx, ddt, dAc.sum((0, 2)), dBp.sum(0), dCp.sum(0), dDc.sum((0, 2))


SCAN_GRAD_TOL_BF16 = 0.5   # chip_smoke.py SCAN_GRAD_TOL["bfloat16"]


@pytest.mark.parametrize("rounded", [False, True], ids=["float32", "bf16_operands"])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_tensor_core_route_model_matches_autograd(case, rounded):
    B, S, H, G, N, P, chunk = case
    args = list(_inputs(2, B, S, H, G, N, P, dt_max=0.5))
    if rounded:   # the kernel's bf16 inputs
        for i in (0, 3, 4, 6):
            args[i] = _bf16(args[i])
    want = _torch_grads(*args, chunk)
    # two head blocks where a group has heads enough to split
    got = tc_model(*args, chunk, rounded, heads_per_block=max(1, (H // G) // 2))
    for g, w, name in zip(got, want, NAMES):
        if not rounded:
            _close(g, w, name)
            continue
        err = np.abs(g - w).max() / np.sqrt(np.mean(w ** 2))
        assert err <= SCAN_GRAD_TOL_BF16, f"{name}: max err / rms {err:.3g}"


@pytest.mark.parametrize("dtype, N, P, S, chunk, want", [
    (torch.bfloat16, 64, 64, 2048, 256, "tensor_cores"),   # zamba2-2.7b's training step
    (torch.bfloat16, 64, 64, 509, 256, "tensor_cores"),    # a ragged tail
    (torch.bfloat16, 64, 64, 100, 512, "tensor_cores"),    # the chunk cut to S
    (torch.float32, 64, 64, 2048, 256, "cuda_cores"),      # float32 keeps its exact products
    (torch.bfloat16, 70, 64, 130, 64, "cuda_cores"),       # N past one tile
    (torch.bfloat16, 64, 32, 130, 64, "cuda_cores"),       # P below one tile
    (torch.bfloat16, 64, 64, 1024, 512, "cuda_cores"),     # a row of C B^T past shared memory
])
def test_backward_route(dtype, N, P, S, chunk, want):
    """``backward_route`` names the route csrc/mamba2_ssd_bwd.cu takes
    (``tc_route``: bf16, N = P = 64, L <= 256)."""
    x = torch.empty(1, S, 2, P, dtype=dtype, device="meta")
    Bm = torch.empty(1, S, 1, N, dtype=dtype, device="meta")
    assert ssd.backward_route(x, Bm, chunk) == want


# -- the autograd route ------------------------------------------------------------


def _plain_launches(monkeypatch):
    calls = []

    def fwd(x, dt, A, Bm, Cm, D, state, chunk, kernel=None):
        calls.append("fwd")
        return ssd.ssd_chunked_plain(x, dt, A, Bm, Cm, D, state, chunk=chunk)

    def bwd(x, dt, A, Bm, Cm, D, dy, chunk):
        calls.append("bwd")
        return ssd.ssd_chunked_backward_plain(x, dt, A, Bm, Cm, D, dy, chunk=chunk)

    monkeypatch.setattr(ssd, "_launch", fwd)
    monkeypatch.setattr(ssd, "_launch_backward", bwd)
    return calls


def _leaves():
    *args, dy = _inputs(3, 1, 40, 4, 2, 8, 8)
    return [torch.from_numpy(a).requires_grad_(True) for a in args], torch.from_numpy(dy)


def test_function_runs_forward_then_backward(monkeypatch):
    calls = _plain_launches(monkeypatch)
    leaves, dy = _leaves()
    y, h = ssd._SSD.apply(*leaves, 16)
    (y * dy).sum().backward()
    assert calls == ["fwd", "bwd"]
    want = ssd.ssd_chunked_backward_plain(*leaves, dy, chunk=16)
    for leaf, w, name in zip(leaves, want, NAMES):
        np.testing.assert_allclose(leaf.grad.numpy(), w.numpy(), atol=1e-6, rtol=1e-6,
                                   err_msg=name)


def test_final_state_gradient_raises(monkeypatch):
    _plain_launches(monkeypatch)
    leaves, dy = _leaves()
    y, h = ssd._SSD.apply(*leaves, 16)
    with pytest.raises(NotImplementedError, match="item 12f"):
        ((y * dy).sum() + h.sum()).backward()


def test_initial_state_raises_under_grad():
    x = torch.empty(1, 16, 4, 64, device="meta").requires_grad_(True)
    dt = torch.empty(1, 16, 4, device="meta")
    bc = torch.empty(1, 16, 1, 64, device="meta")
    vec = torch.empty(4, device="meta")
    state = torch.empty(1, 4, 64, 64, device="meta")
    before = (ssd.launches, ssd.launches_backward)
    with pytest.raises(NotImplementedError, match="item 12f"):
        ssd.ssd_chunked(x, dt, vec, bc, bc, vec, state, chunk=8)
    assert (ssd.launches, ssd.launches_backward) == before
