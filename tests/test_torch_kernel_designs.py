"""The designs of the grouped-matmul and mLSTM kernels
(``repro_torch/kernels/csrc/grouped_matmul.cu`` and ``mlstm.cu``), held on
the CPU.

The kernels run only on the card, so these tests pin what they rely on,
modelled in numpy and torch step by step as the kernels run it:

* grouped matmul: numpy copies of the bf16 routes' schedules (the wgmma
  route's persistent tile walk, ``gmm_wgmma``'s index arithmetic; the
  stream route's grid of (slab, expert) blocks whose warps take the ring
  stages in turn) cover every output element and every element of w
  exactly once, and the sums they form (per tile; per warp, added in warp
  order) equal the plain product; the route rule sends every bf16 view
  the wrapper accepts to the TMA kernels;
* mLSTM: the tensor-core route's decomposition (each chunk's dC =
  k^T (e^{a-g_L} v) and dn, then the in-order combine C = e^{m_prev-g_L} C
  + dC in float32, then h from q C_prev and the decay-weighted causal
  scores, the last chunk padded and masked) against the Pallas kernel in
  interpret mode and the plain version, at the tolerances
  ``tests/test_torch_xlstm.py`` uses (1e-4 for the same chunking; h 5e-4 /
  rtol 1e-3, C and n 5e-3 / rtol 1e-2 for another chunking); and its bf16
  operand rounding (q / sqrt(dk) as a product with the reciprocal, P and
  C_prev rounded once, the decay-weighted v as a bf16 hi + lo pair) within
  ``chip_smoke.py``'s ``MLSTM_TOL["bfloat16"]`` of the float32 plain
  version on the same bf16 inputs.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.kernels.mlstm import mlstm_chunked_kernel
from repro_torch.kernels import _build
from repro_torch.kernels import grouped_matmul as gmm
from repro_torch.kernels import mlstm as M
from repro_torch.kernels.ref import grouped_matmul_ref

SMS = 132                       # an H100's SMs: the persistent grid
MLSTM_TOL_BF16 = {"h": (2e-2, 1e-2), "state": (5e-3, 1e-2)}   # chip_smoke.MLSTM_TOL
STREAM_COLS, STREAM_ROWS, STREAM_WARPS = 256, 16, 4   # csrc/grouped_matmul.cu kSCols, kSRows, kSWarps


# -- grouped matmul: schedule -------------------------------------------------


def _ranges(n, step):
    return [(i, min(n, i + step)) for i in range(0, n, step)]


def _prefill_tiles(E, C, f):
    """``gmm_wgmma``'s tiles in walk order: tile t is (t / (E nf), (t / nf)
    % E, t % nf), i.e. (256-row chunk of C, expert, 128-column f tile), full
    chunks first; persistent block b of a grid of g takes tiles b, b + g, ..."""
    nm, nf = -(-C // gmm.WGMMA_M), -(-f // gmm.WGMMA_N)
    return [(t // (E * nf), (t // nf) % E, t % nf) for t in range(nm * E * nf)]


@pytest.mark.parametrize("f", [22, 1024, 1408, 2048])
@pytest.mark.parametrize("C", [1, 8, 37, 64, 160, 256])
@pytest.mark.parametrize("E", [3, 60, 64])
def test_gmm_schedule_covers_everything_once(E, C, f):
    d = 2048
    if C <= gmm.SKINNY_ROWS:
        # stream route: a block per (slab, expert) streams all d rows of its
        # slab; ring stage i goes to consumer warp i % 4
        slabs = _ranges(f, STREAM_COLS)
        stages = _ranges(d, STREAM_ROWS)
        w_reads = np.zeros((E, d, f), np.int32)
        writes = np.zeros((E, C, f), np.int32)
        for e in range(E):
            for c0, c1 in slabs:
                for warp in range(STREAM_WARPS):
                    for r0, r1 in stages[warp::STREAM_WARPS]:
                        w_reads[e, r0:r1, c0:c1] += 1
                writes[e, :, c0:c1] += 1
        assert (w_reads == 1).all() and (writes == 1).all()
        return
    # wgmma route: a persistent grid walks (chunk, expert, f tile) tiles
    tiles = _prefill_tiles(E, C, f)
    grid = min(len(tiles), SMS)
    walked = [tiles[t] for b in range(grid) for t in range(b, len(tiles), grid)]
    assert sorted(walked) == sorted(tiles) and len(set(walked)) == len(walked)
    per_block = [len(range(b, len(tiles), grid)) for b in range(grid)]
    assert max(per_block) - min(per_block) <= 1                    # balanced to one tile
    chunks = _ranges(C, gmm.WGMMA_M)
    ftiles = _ranges(f, gmm.WGMMA_N)
    out = np.zeros((E, C, f), np.int32)
    w_reads = np.zeros((E, f), np.int32)                            # per w column, all d rows
    for mi, e, fi in tiles:
        (r0, r1), (c0, c1) = chunks[mi], ftiles[fi]
        out[e, r0:r1, c0:c1] += 1
        w_reads[e, c0:c1] += 1
    assert (out == 1).all()
    assert (w_reads == len(chunks)).all()                           # once per 256 rows of C
    # full chunks of C before the partial one
    sizes = [chunks[mi][1] - chunks[mi][0] for mi, _, _ in tiles]
    assert sizes == sorted(sizes, reverse=True)


@pytest.mark.parametrize("E,C,d,f", [(3, 5, 40, 22), (2, 8, 300, 264), (1, 1, 16, 8),
                                     (2, 8, 38, 21)])
def test_gmm_stream_warp_sums_match_plain(E, C, d, f):
    """Each consumer warp sums the ring stages it takes (float32), the
    block adds the warps in warp order: the plain product within float32
    rounding."""
    rng = np.random.default_rng(E * 100 + d)
    x = rng.standard_normal((E, C, d), np.float32)
    w = rng.standard_normal((E, d, f), np.float32) / np.sqrt(d)
    stages = _ranges(d, STREAM_ROWS)
    parts = [sum((np.einsum("ecd,edf->ecf", x[:, :, r0:r1], w[:, r0:r1])
                  for r0, r1 in stages[warp::STREAM_WARPS]), np.zeros((E, C, f), np.float32))
             for warp in range(STREAM_WARPS)]
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    want = grouped_matmul_ref(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    np.testing.assert_allclose(out, want, atol=2e-5, rtol=0)


@pytest.mark.parametrize("grid", [1, 5, 132])
def test_gmm_tile_walk_sums_match_plain(grid):
    E, C, d, f = 3, 300, 64, 136                  # two chunks of C, a ragged f tile
    rng = np.random.default_rng(grid)
    x = rng.standard_normal((E, C, d), np.float32)
    w = rng.standard_normal((E, d, f), np.float32) / np.sqrt(d)
    tiles = _prefill_tiles(E, C, f)
    out = np.full((E, C, f), np.nan, np.float32)
    for b in range(min(grid, len(tiles))):
        for t in range(b, len(tiles), min(grid, len(tiles))):
            mi, e, fi = tiles[t]
            r = slice(mi * gmm.WGMMA_M, min(C, (mi + 1) * gmm.WGMMA_M))
            c = slice(fi * gmm.WGMMA_N, min(f, (fi + 1) * gmm.WGMMA_N))
            out[e, r, c] = x[e, r] @ w[e, :, c]
    want = np.einsum("ecd,edf->ecf", x, w)
    np.testing.assert_allclose(out, want, atol=2e-5, rtol=0)


# -- grouped matmul: route -----------------------------------------------------


def _views(kind, E, C, d, f, dtype):
    if kind == "contiguous":
        return torch.zeros(E, C, d, dtype=dtype), torch.zeros(E, d, f, dtype=dtype)
    if kind == "pad":                  # chip_smoke's ragged strided views: rows padded to 8
        dp, fp = -(-d // 8) * 8, -(-f // 8) * 8
        return (torch.zeros(E, C, dp, dtype=dtype)[..., :d],
                torch.zeros(E, dp, fp, dtype=dtype)[:, :d, :f])
    if kind == "layer":                # one layer's up half of stacked [gate | up] weights
        return (torch.zeros(E, C, d, dtype=dtype),
                torch.zeros(2, E, d, 2 * f, dtype=dtype)[1, :, :, f:])
    if kind == "offset":               # a base 2 bytes past 16-byte alignment
        return (torch.zeros(E * C * d + 1, dtype=dtype)[1:].view(E, C, d),
                torch.zeros(E, d, f, dtype=dtype))
    raise ValueError(kind)


@pytest.mark.parametrize("kind,C,d,f,dtype,want", [
    ("contiguous", 8, 2048, 1024, torch.bfloat16, "stream"),
    ("contiguous", 160, 2048, 1024, torch.bfloat16, "wgmma"),
    ("contiguous", 160, 2048, 1408, torch.bfloat16, "wgmma"),
    ("layer", 8, 2048, 1024, torch.bfloat16, "stream"),
    ("layer", 160, 2048, 1024, torch.bfloat16, "wgmma"),
    ("pad", 5, 38, 22, torch.bfloat16, "stream"),
    ("pad", 37, 38, 22, torch.bfloat16, "wgmma"),
    ("pad", 37, 38, 21, torch.bfloat16, "wgmma"),
    ("contiguous", 5, 40, 24, torch.bfloat16, "stream"),
    ("contiguous", 8, 2048, 1024, torch.float32, "skinny"),
    ("contiguous", 160, 2048, 1024, torch.float32, "tiled"),
    ("pad", 37, 38, 22, torch.float32, "tiled"),
])
def test_gmm_route_takes_tma_for_every_bf16_view(kind, C, d, f, dtype, want):
    x, w = _views(kind, 3, C, d, f, dtype)
    assert gmm.route(x, w) == want


@pytest.mark.parametrize("kind,d,f,aligned", [
    ("contiguous", 40, 24, True), ("pad", 38, 22, True), ("pad", 38, 21, True),
    ("layer", 40, 24, True), ("contiguous", 38, 22, False), ("offset", 40, 24, False)])
def test_gmm_wrapper_alignment_rule_is_tmas(kind, d, f, aligned):
    """The wrapper accepts a view only with a 16-byte aligned base and outer
    strides (``_build.check_inputs``), which is what a TMA tensor map needs:
    chip_smoke's ragged views (rows padded to 8 elements) pass; contiguous
    ragged rows and a base 2 bytes off are refused before any route is
    taken."""
    x, w = _views(kind, 3, 37, d, f, torch.bfloat16)
    assert (_build._aligned(x) and _build._aligned(w)) == aligned


# -- mLSTM: the tensor-core route's decomposition --------------------------------


def _log_sigmoid(x):
    return np.minimum(x, 0) - np.log1p(np.exp(-np.abs(x)))


def mlstm_tc_model(q, k, v, i_pre, f_pre, state, chunk, rnd=None):
    """The tensor-core route in float32 numpy (kernel layout: q, k (BH, S,
    dk), v (BH, S, dv), gates (BH, S)).  The chunk is ``min(chunk, S)`` and
    the last chunk is padded with q = k = v = 0, log-forget 0 and input gate
    -inf, as the kernel masks it.  ``rnd`` (a function) stands for the bf16
    operand rounding: applied to q / sqrt(dk), P, C_prev and the
    decay-weighted v (the latter as hi + lo).  Returns (h, (C, n, m))."""
    rnd = rnd or (lambda a: a)
    BH, S, dk = q.shape
    dv = v.shape[-1]
    L = min(chunk, S)
    nc = -(-S // L)
    pad = nc * L - S

    def padded(a, fill):
        return np.concatenate([a, np.full((BH, pad, *a.shape[2:]), fill, np.float32)], axis=1)

    qs = rnd(padded(q, 0.0) * np.float32(1.0 / math.sqrt(dk)))
    kk, vv = padded(k, 0.0), padded(v, 0.0)
    flog = padded(_log_sigmoid(f_pre.astype(np.float32)), 0.0)
    ig = padded(i_pre.astype(np.float32), -np.inf)
    if state is None:
        C = np.zeros((BH, dk, dv), np.float32)
        n = np.zeros((BH, dk), np.float32)
        m = np.full((BH,), -np.inf, np.float32)
    else:
        C, n, m = (np.array(s, np.float32) for s in state)
    h = np.zeros((BH, nc * L, dv), np.float32)
    tri = np.tril(np.ones((L, L), bool))
    for c in range(nc):
        sl = slice(c * L, (c + 1) * L)
        Fc = np.cumsum(flog[:, sl], axis=1)
        a = ig[:, sl] - Fc
        g = np.maximum(m[:, None], np.maximum.accumulate(a, axis=1))
        # the fused pass: q C_prev and the decay-weighted causal scores
        with np.errstate(invalid="ignore"):
            w_ts = np.exp(np.where(tri, a[:, None, :] - g[:, :, None], -np.inf))
        Pf = np.where(tri, (qs[:, sl] @ kk[:, sl].transpose(0, 2, 1)) * w_ts, 0.0)
        sc = np.exp(m[:, None] - g)
        num = rnd(Pf) @ vv[:, sl] + sc[..., None] * (qs[:, sl] @ rnd(C))
        den = Pf.sum(-1) + sc * np.einsum("btd,bd->bt", qs[:, sl], n)   # float P, as the kernel
        h[:, sl] = num / np.maximum(np.abs(den), np.exp(-(Fc + g)))[..., None]
        # the state pass: this chunk's update, then the in-order combine
        gl = g[:, -1]
        dec = np.exp(a - gl[:, None])
        vd = vv[:, sl] * dec[..., None]
        hi = rnd(vd)
        dC = kk[:, sl].transpose(0, 2, 1) @ hi + kk[:, sl].transpose(0, 2, 1) @ rnd(vd - hi)
        dn = np.einsum("bs,bsd->bd", dec, kk[:, sl])
        fdec = np.exp(m - gl)
        C = fdec[:, None, None] * C + dC
        n = fdec[:, None] * n + dn
        m = Fc[:, -1] + gl
    return h[:, :S], (C, n, m)


def _mlstm_inputs(rng, BH, S, dk, dv):
    def nrm(*shape):
        return rng.standard_normal(shape).astype(np.float32)
    return nrm(BH, S, dk), nrm(BH, S, dk), nrm(BH, S, dv), nrm(BH, S), nrm(BH, S) + 2.0


def _mlstm_state(rng, BH, dk, dv):
    return (rng.standard_normal((BH, dk, dv)).astype(np.float32),
            np.abs(rng.standard_normal((BH, dk))).astype(np.float32) + 0.5,
            rng.standard_normal(BH).astype(np.float32))


def _close(got, want, atol, rtol):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               atol=atol, rtol=rtol)


@pytest.mark.parametrize("with_state", [False, True], ids=["empty", "state"])
@pytest.mark.parametrize("S,chunk,pallas_chunk", [
    (256, 64, 64),      # four chunks of 64, the Pallas kernel chunked alike
    (300, 256, 150),    # 256 + 44 masked; the Pallas kernel in chunks of 150
    (509, 256, 509),    # 256 + 253 masked; the Pallas kernel in one chunk
])
def test_mlstm_chunk_state_walk_matches_pallas_and_plain(S, chunk, pallas_chunk, with_state):
    rng = np.random.default_rng(S + with_state)
    BH, dk, dv = 2, 16, 32
    xs = _mlstm_inputs(rng, BH, S, dk, dv)
    st = _mlstm_state(rng, BH, dk, dv) if with_state else None
    h, (C, n, m) = mlstm_tc_model(*xs, st, chunk)
    ph, (pC, pn, pm) = mlstm_chunked_kernel(
        *map(jnp.asarray, xs), None if st is None else tuple(map(jnp.asarray, st)),
        chunk=pallas_chunk, interpret=True)
    same = chunk == pallas_chunk
    tol_h = (1e-4, 1e-4) if same else (5e-4, 1e-3)
    tol_s = (1e-4, 1e-4) if same else (5e-3, 1e-2)
    _close(h, ph, *tol_h)
    _close(C, pC, *tol_s)
    _close(n, pn, *tol_s)
    _close(m, np.asarray(pm).reshape(-1), 1e-4, 1e-4)
    # the plain version (its divisor chunk rule: 64, 150, 1)
    t = lambda a: torch.from_numpy(np.asarray(a))
    gh, (gC, gn, gm) = M.mlstm_chunked_plain(*map(t, xs), None if st is None else tuple(map(t, st)),
                                             chunk=chunk)
    _close(h, gh.numpy(), *((1e-4, 1e-4) if S == 256 else (5e-4, 1e-3)))
    _close(C, gC.numpy(), *((1e-4, 1e-4) if S == 256 else (5e-3, 1e-2)))
    _close(n, gn.numpy(), *((1e-4, 1e-4) if S == 256 else (5e-3, 1e-2)))
    _close(m, gm.numpy(), 1e-4, 1e-4)


def _bf16(a):
    return torch.from_numpy(np.ascontiguousarray(a)).to(torch.bfloat16).float().numpy()


@pytest.mark.parametrize("with_state", [False, True], ids=["empty", "state"])
@pytest.mark.parametrize("S", [256, 300, 509])
def test_mlstm_bf16_operand_rounding_within_tolerance(S, with_state):
    """bf16 inputs; the kernel's roundings (q / sqrt(dk), P, C_prev once;
    decay-weighted v as hi + lo) against the float32 plain version on the
    same bf16 inputs, at a reduced width.  q and k are |N(0, 1)| as in
    chip_smoke, so no denominator cancels."""
    rng = np.random.default_rng(7 * S + with_state)
    BH, dk, dv = 2, 64, 128
    q, k, v, i_pre, f_pre = _mlstm_inputs(rng, BH, S, dk, dv)
    xs = [_bf16(np.abs(q)), _bf16(np.abs(k)), _bf16(v), _bf16(i_pre), _bf16(f_pre)]
    st = None
    if with_state:      # a state from the plain version on a 64-token prefix
        pre = [_bf16(np.abs(a)) if j < 2 else _bf16(a)
               for j, a in enumerate(_mlstm_inputs(rng, BH, 64, dk, dv))]
        st = tuple(s.numpy() for s in M.mlstm_chunked_plain(
            *(torch.from_numpy(a) for a in pre), None, chunk=64)[1])
    h, (C, n, m) = mlstm_tc_model(*xs, st, 256, rnd=_bf16)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(torch.bfloat16)
    ph, (pC, pn, pm) = M.mlstm_chunked_plain(*map(t, xs), None if st is None else
                                             tuple(torch.from_numpy(s) for s in st), chunk=256)
    assert ph.dtype == torch.bfloat16
    _close(_bf16(h), ph.float().numpy(), *MLSTM_TOL_BF16["h"])
    for got, want in zip((C, n, m), (pC, pn, pm)):
        _close(got, want.numpy(), *MLSTM_TOL_BF16["state"])


def test_mlstm_route_rule():
    bf, f32 = torch.bfloat16, torch.float32
    z = lambda d, dtype: torch.zeros(1, 1, 4, d, dtype=dtype)
    assert M.route(z(512, bf), z(1024, bf)) == "tensor_cores"      # xlstm-1.3b
    assert M.route(z(256, bf), z(256, bf)) == "tensor_cores"
    assert M.route(z(512, f32), z(1024, f32)) == "cuda_cores"      # float32 stays exact
    assert M.route(z(16, bf), z(32, bf)) == "cuda_cores"           # narrower than a tile
    assert M.route(z(1024, bf), z(1024, bf)) == "cuda_cores"       # q rows past shared memory
    assert M.route(z(512, bf), z(384, bf)) == "cuda_cores"


def test_mlstm_model_padding_is_exact():
    """The masked tail changes nothing: chunk 256 over S = 300 (256 + 44
    padded to 512) equals chunk 300 (one chunk, no padding)."""
    rng = np.random.default_rng(3)
    xs = _mlstm_inputs(rng, 2, 300, 16, 32)
    h1, s1 = mlstm_tc_model(*xs, None, 256)
    h2, s2 = mlstm_tc_model(*xs, None, 300)
    _close(h1, h2, 5e-4, 1e-3)
    for a, b in zip(s1, s2):
        _close(a, b, 5e-3, 1e-2)


def test_log_sigmoid_matches_torch():
    x = np.linspace(-30, 30, 101, dtype=np.float32)
    _close(_log_sigmoid(x), F.logsigmoid(torch.from_numpy(x)).numpy(), 1e-6, 1e-6)
