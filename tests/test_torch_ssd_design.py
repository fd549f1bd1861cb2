"""The design of the SSD kernel's tensor-core route
(``repro_torch/kernels/csrc/mamba2_ssd.cu``), held on the CPU.

The kernel runs only on the card, so these tests pin what it relies on,
modelled in numpy step by step as its three passes run it:

* pass 1 (one block per chunk): Lc by a scan over the chunk, positions past
  S masked (dt = 0, x = B = C = 0), and the chunk's state update
  dh = (B w)^T x with w_s = e^{Lc_L - Lc_s} dt_s; pass 2: the in-order
  combine h = e^{Lc_L} h + dh in float32, h stored at every chunk start;
  pass 3 (one block per 64-position tile of a chunk, heaviest first):
  e^{Lc_t} C_t h_prev plus, per source tile on or below the diagonal, the
  decay-weighted causal C_t B_s^T tile times x_s, then D x_t; below the
  diagonal the decay is a row factor e^{Lc_t - Lc_e} times the tile-local
  weight wt_s = e^{Lc_e - Lc_s} dt_s that pass 1 stores (e the source tile's
  last position), both at most 1, so no exponent overflows.  The model
  is held against the Pallas kernel in interpret mode and against the
  plain version at the tolerances ``tests/test_torch_mamba2.py`` uses
  (1e-4 for the same chunking; y 5e-4 / rtol 1e-3 and h 5e-3 / rtol 1e-2
  across chunkings);
* the bf16 operand rounding (P, the weighted B and h_prev each rounded
  once to bf16, y once at the end) within ``chip_smoke.py``'s
  ``SSD_TOL["bfloat16"]`` of the float32 plain version on the same bf16
  inputs, at the kernel's widths (N = P = 64, chunk 256): one rounding of
  the weighted B uses about a fifth of the state tolerance there, so the
  kernel rounds it once (the mLSTM's state pass needs a hi + lo pair);
* the output grid's heaviest-first order covers every (position, head,
  sequence) exactly once, and the scratch of the passes is one allocation
  cut into the parts the kernel indexes;
* the route rule: bf16 takes the tensor cores, float32 the CUDA cores, and
  every view the wrapper accepts is one the 16-byte ``cp.async`` copies read.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.kernels.mamba2_ssd import ssd_chunked_kernel
from repro_torch.kernels import _build
from repro_torch.kernels import mamba2_ssd as K

TILE = 64                                                      # csrc/mamba2_ssd.cu kT
SSD_TOL_BF16 = {"y": (2e-2, 1e-2), "state": (5e-3, 1e-2)}    # chip_smoke.SSD_TOL["bfloat16"]
SAME, Y_TOL, H_TOL = (1e-4, 1e-4), (5e-4, 1e-3), (5e-3, 1e-2)


def _ident(a):
    return a


def _bf16(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(torch.bfloat16).float().numpy()


def _dims(S, chunk):
    L = min(chunk, S)
    nc = -(-S // L)
    return L, nc, -(-L // TILE) * TILE


def _chunk_rows(a, c, L, Lp, S):
    """Positions c L .. c L + Lp - 1 of a model-layout (B, S, ...) array,
    zero past the chunk's valid positions (min(L, S - c L))."""
    nvalid = min(L, S - c * L)
    out = np.zeros((a.shape[0], Lp, *a.shape[2:]), np.float32)
    out[:, :nvalid] = a[:, c * L:c * L + nvalid]
    return out


def chunk_states(x, dt, A, Bm, chunk, rnd=_ident):
    """Pass 1.  Returns Lc, dt and the tile-local weight wt per position,
    (B, H, nc, Lp) each, and each chunk's dh (B, H, nc, N, P); ``rnd``
    rounds the weighted B."""
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2:]
    L, nc, Lp = _dims(S, chunk)
    lc = np.zeros((Bsz, H, nc, Lp), np.float32)
    dtp = np.zeros_like(lc)
    wt = np.zeros_like(lc)
    dh = np.zeros((Bsz, H, nc, N, P), np.float32)
    ends = np.arange(Lp) | (TILE - 1)                                    # each tile's last position
    for c in range(nc):
        d = _chunk_rows(dt, c, L, Lp, S).transpose(0, 2, 1)               # (B, H, Lp)
        lc[:, :, c] = np.cumsum(A[None, :, None] * d, axis=-1)
        dtp[:, :, c] = d
        wt[:, :, c] = np.exp(lc[:, :, c, ends] - lc[:, :, c]) * d
        w = np.exp(lc[:, :, c, -1:] - lc[:, :, c]) * d                   # masked: dt = 0
        xs = _chunk_rows(x, c, L, Lp, S).transpose(0, 2, 1, 3)            # (B, H, Lp, P)
        bs = np.repeat(_chunk_rows(Bm, c, L, Lp, S), H // G, axis=2).transpose(0, 2, 1, 3)
        dh[:, :, c] = rnd(bs * w[..., None]).transpose(0, 1, 3, 2) @ xs
    return lc, dtp, wt, dh


def combine(lc, dh, h0):
    """Pass 2: h at the start of every chunk, and the final h."""
    Bsz, H, nc, N, P = dh.shape
    h = np.zeros((Bsz, H, N, P), np.float32) if h0 is None else h0.astype(np.float32)
    starts = []
    for c in range(nc):
        starts.append(h)
        h = np.exp(lc[:, :, c, -1])[..., None, None] * h + dh[:, :, c]
    return starts, h


def output_order(S, chunk):
    """Pass 3's blocks in launch order (blockIdx.z): (tile ti, chunk ch),
    ti from the last and, among one ti, chunk 0 (no h_prev term without an
    initial state) last; tiles of masked positions only are skipped."""
    L, nc, Lp = _dims(S, chunk)
    nt = Lp // TILE
    order = []
    for z in range(nc * nt):
        ti, ch = nt - 1 - z // nc, (z % nc + 1) % nc
        if ti * TILE < min(L, S - ch * L):
            order.append((ti, ch))
    return order


def outputs(x, Bm, Cm, D, lc, dtp, wt, h_starts, has_state, chunk, rnd=_ident):
    """Pass 3, block by block in launch order.  ``rnd`` rounds P and h_prev
    (y is rounded by the caller).  Returns y and how often each position
    was written."""
    Bsz, S, H, P = x.shape
    G = Bm.shape[2]
    L, nc, Lp = _dims(S, chunk)
    y = np.zeros((Bsz, S, H, P), np.float32)
    writes = np.zeros(S, np.int32)
    for ti, ch in output_order(S, chunk):
        nvalid = min(L, S - ch * L)
        xs = _chunk_rows(x, ch, L, Lp, S).transpose(0, 2, 1, 3)
        bs = np.repeat(_chunk_rows(Bm, ch, L, Lp, S), H // G, axis=2).transpose(0, 2, 1, 3)
        cs = np.repeat(_chunk_rows(Cm, ch, L, Lp, S), H // G, axis=2).transpose(0, 2, 1, 3)
        t = slice(ti * TILE, (ti + 1) * TILE)
        lt, ct = lc[:, :, ch, t], cs[:, :, t]
        acc = np.zeros((Bsz, H, TILE, P), np.float32)
        if has_state or ch > 0:
            acc = np.exp(lt)[..., None] * (ct @ rnd(h_starts[ch]))
        for si in range(ti + 1):
            s = slice(si * TILE, (si + 1) * TILE)
            scores = ct @ bs[:, :, s].transpose(0, 1, 3, 2)
            if si == ti:                 # the diagonal tile: no exponent above it
                keep = np.tril(np.ones((TILE, TILE), bool))
                expo = np.where(keep, lt[..., :, None] - lc[:, :, ch, None, s], 0.0)
                pm = np.where(keep, scores * np.exp(expo) * dtp[:, :, ch, None, s], 0.0)
            else:                        # below it: row factor times tile-local weight
                rows = np.exp(lt - lc[:, :, ch, s.stop - 1, None])
                pm = scores * rows[..., :, None] * wt[:, :, ch, None, s]
            acc = acc + rnd(pm) @ xs[:, :, s]
        rows = slice(ti * TILE, min((ti + 1) * TILE, nvalid))
        n = rows.stop - rows.start
        out = acc[:, :, :n] + D[None, :, None, None] * xs[:, :, rows]
        y[:, ch * L + rows.start:ch * L + rows.stop] = out.transpose(0, 2, 1, 3)
        writes[ch * L + rows.start:ch * L + rows.stop] += 1
    return y, writes


def ssd_tc_model(x, dt, A, Bm, Cm, D, h0, chunk, rnd=_ident):
    """The three passes; ``rnd`` stands for the bf16 operand rounding.
    Returns (y, final h, per-position write counts)."""
    lc, dtp, wt, dh = chunk_states(x, dt, A, Bm, chunk, rnd)
    starts, hN = combine(lc, dh, h0)
    y, writes = outputs(x, Bm, Cm, D, lc, dtp, wt, starts, h0 is not None, chunk, rnd)
    return y, hN, writes


def _inputs(rng, B, S, H, G, N, P):
    """As tests/test_torch_mamba2.py draws them: x, B, C ~ N(0, 1); dt in the
    model's softplus range; A = -linspace(1, 16, H); D ~ N(0, 1)."""
    def n(*shape):
        return rng.standard_normal(shape, np.float32)

    dt = np.log1p(np.exp(n(B, S, H) - 2.0)).astype(np.float32)
    A = -np.linspace(1.0, 16.0, H, dtype=np.float32)
    return n(B, S, H, P), dt, A, n(B, S, G, N), n(B, S, G, N), n(H)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               atol=tol[0], rtol=tol[1])


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dtype)


# -- the three-pass decomposition --------------------------------------------------


@pytest.mark.parametrize("G", [1, 2])
@pytest.mark.parametrize("with_state", [False, True], ids=["empty", "state"])
@pytest.mark.parametrize("S,chunk,pallas_chunk", [
    (256, 64, 64),      # four chunks of one tile each, the Pallas kernel chunked alike
    (300, 256, 150),    # 256 + 44 masked; the Pallas kernel in chunks of 150
    (509, 256, 509),    # 256 + 253 masked; the Pallas kernel in one chunk
    (37, 256, 37),      # one chunk, one ragged tile
])
def test_ssd_three_passes_match_pallas_and_plain(S, chunk, pallas_chunk, with_state, G):
    rng = np.random.default_rng(S + 10 * with_state + G)
    B, H, N, P = 2, 4, 16, 16
    x, dt, A, Bm, Cm, D = _inputs(rng, B, S, H, G, N, P)
    h0 = rng.standard_normal((B, H, N, P), np.float32) if with_state else None
    y, hN, writes = ssd_tc_model(x, dt, A, Bm, Cm, D, h0, chunk)
    assert (writes == 1).all()
    # the Pallas kernel's layout: B/C repeated per head, log lambda given, D x added after
    heads = lambda a: a.transpose(0, 2, 1, 3).reshape(B * H, S, -1)
    py, ph = ssd_chunked_kernel(
        jnp.asarray(heads(x)), jnp.asarray(dt.transpose(0, 2, 1).reshape(B * H, S)),
        jnp.asarray((A * dt).transpose(0, 2, 1).reshape(B * H, S)),
        jnp.asarray(heads(np.repeat(Bm, H // G, axis=2))),
        jnp.asarray(heads(np.repeat(Cm, H // G, axis=2))),
        None if h0 is None else jnp.asarray(h0.reshape(B * H, N, P)),
        chunk=pallas_chunk, interpret=True)
    py = np.asarray(py).reshape(B, H, S, P).transpose(0, 2, 1, 3) + x * D[None, None, :, None]
    same = _dims(S, chunk)[0] == pallas_chunk
    _close(y, py, SAME if same else Y_TOL)
    _close(hN, np.asarray(ph).reshape(B, H, N, P), SAME if same else H_TOL)
    # the plain version (its divisor chunk rule: 64, 150, 1 and 37)
    gy, gh = K.ssd_chunked_plain(*map(_t, (x, dt, A, Bm, Cm, D)),
                                 None if h0 is None else _t(h0), chunk=chunk)
    same = _dims(S, chunk)[0] == _dims(S, K.divisor_chunk(chunk, S))[0]
    _close(y, gy.numpy(), SAME if same else Y_TOL)
    _close(hN, gh.numpy(), SAME if same else H_TOL)


def test_ssd_masked_tail_is_exact():
    """Chunk 256 over S = 300 (256 + 44, the second chunk padded to 64) and
    chunk 200 over S = 300 (200 + 100, both chunks padded to 256: L no
    multiple of the tile) equal one unpadded chunk of 300 positions, as the
    float32 plain version runs it."""
    rng = np.random.default_rng(3)
    xs = _inputs(rng, 2, 300, 4, 2, 16, 16)
    gy, gh = K.ssd_chunked_plain(*map(_t, xs), None, chunk=300)
    for chunk in (256, 200):
        y, hN, _ = ssd_tc_model(*xs, None, chunk)
        _close(y, gy.numpy(), Y_TOL)
        _close(hN, gh.numpy(), H_TOL)


def test_ssd_factored_decay_never_overflows():
    """Decays of e^{-16} a position (A = -16, dt = 1): Lc falls by ~4000 over
    a chunk, so e^{Lc_s - Lc_t} and e^{Lc_e - Lc_t} would overflow; the
    kernel's factors are all e^{<= 0}, and y stays finite and equal to the
    plain version's."""
    rng = np.random.default_rng(4)
    x, _, _, Bm, Cm, D = _inputs(rng, 1, 300, 2, 1, 16, 16)
    dt = np.ones((1, 300, 2), np.float32)
    A = np.array([-16.0, -0.01], np.float32)
    lc, _, wt, _ = chunk_states(x, dt, A, Bm, 256)
    assert np.isfinite(wt).all() and (wt <= 1).all()
    y, hN, _ = ssd_tc_model(x, dt, A, Bm, Cm, D, None, 256)
    assert np.isfinite(y).all() and np.isfinite(hN).all()
    gy, gh = K.ssd_chunked_plain(*map(_t, (x, dt, A, Bm, Cm, D)), None, chunk=300)
    _close(y, gy.numpy(), Y_TOL)
    _close(hN, gh.numpy(), H_TOL)


# -- the bf16 operand rounding ---------------------------------------------------


def _served_inputs(rng, B, S, H, G):
    """chip_smoke's SSD inputs at the kernel's widths (N = P = 64), as bf16
    values: x, B, C ~ silu(N(0, 1)); dt = softplus(N(0, 1) + dt_bias), dt_bias
    drawn as ``mamba2_block_init`` draws it; A = -linspace(1, 16, H)."""
    def silu(*shape):
        return F.silu(torch.from_numpy(rng.standard_normal(shape).astype(np.float32))).numpy()

    u = rng.random(H).astype(np.float32)
    dt_bias = np.log(np.expm1(np.exp(np.log(1e-3) + u * np.log(100.0))))
    dt = F.softplus(torch.from_numpy(
        (rng.standard_normal((B, S, H)) + dt_bias).astype(np.float32))).numpy()
    A = -np.linspace(1.0, 16.0, H, dtype=np.float32)
    D = rng.standard_normal(H).astype(np.float32)
    return (_bf16(silu(B, S, H, 64)), dt, A, _bf16(silu(B, S, G, 64)), _bf16(silu(B, S, G, 64)),
            D)


@pytest.mark.parametrize("S,B,H,G,with_state", [
    (1024, 1, 16, 1, False),    # a zamba2 admission's shape, 16 of its 80 heads
    (300, 1, 16, 1, True),      # ragged second chunk
    (509, 1, 8, 1, True),       # prime length
    (200, 2, 8, 2, True),       # B = 2, G = 2
])
def test_ssd_bf16_operand_rounding_within_tolerance(S, B, H, G, with_state):
    """bf16 inputs; the kernel's roundings (P, the weighted B and h_prev
    once, y once) against the float32 plain version on the same bf16
    inputs; a state comes from the plain version on a 64-token prefix."""
    rng = np.random.default_rng(S + B)
    xs = _served_inputs(rng, B, S, H, G)
    h0 = None
    if with_state:
        pre = _served_inputs(rng, B, 64, H, G)
        h0 = K.ssd_chunked_plain(*map(_t, pre), None, chunk=64)[1].numpy()
    y, hN, _ = ssd_tc_model(*xs, h0, 256, rnd=_bf16)
    bf = torch.bfloat16
    x, dt, A, Bm, Cm, D = xs
    py, ph = K.ssd_chunked_plain(_t(x, bf), _t(dt), _t(A), _t(Bm, bf), _t(Cm, bf), _t(D),
                                 None if h0 is None else _t(h0), chunk=256)
    assert py.dtype == bf and ph.dtype == torch.float32
    _close(_bf16(y), py.float().numpy(), SSD_TOL_BF16["y"])
    _close(hN, ph.numpy(), SSD_TOL_BF16["state"])


# -- the schedule and the scratch ------------------------------------------------


@pytest.mark.parametrize("chunk", [64, 200, 256])
@pytest.mark.parametrize("S", [1, 7, 64, 300, 509, 512, 1024, 2048])
def test_ssd_output_grid_covers_every_position_once_heaviest_first(S, chunk):
    L, nc, Lp = _dims(S, chunk)
    order = output_order(S, chunk)
    writes = np.zeros(S, np.int32)
    for ti, ch in order:
        lo = ch * L + ti * TILE
        writes[lo:min(lo + TILE, ch * L + min(L, S - ch * L))] += 1
    assert (writes == 1).all()
    # work of a block: its source tiles plus the h_prev term (chunk > 0,
    # or any chunk with an initial state); launch order never increases it
    for has_state in (False, True):
        work = [ti + 1 + (has_state or ch > 0) for ti, ch in order]
        assert work == sorted(work, reverse=True)
    # every head and sequence runs the same order: grid (H, B, len(order) + skipped)
    assert len(order) <= nc * (Lp // TILE)


@pytest.mark.parametrize("B,S,H,chunk", [
    (1, 1024, 80, 256), (1, 512, 80, 256), (1, 2048, 80, 256), (2, 300, 4, 256),
    (1, 7, 3, 256), (2, 200, 5, 64),
])
def test_ssd_scratch_layout(B, S, H, chunk):
    """The tensor-core route's scratch is one allocation cut into Lc, dt,
    wt, dh and the bf16 h at each chunk start, back to back, in the sizes
    the kernel indexes (csrc/mamba2_ssd.cu Work), each part 16-byte
    aligned for its vector loads."""
    L, nc, Lp = _dims(S, chunk)
    chunks = B * H * nc
    buf, ptrs = K._scratch(chunks, Lp, torch.device("cpu"))
    sizes = [4 * chunks * Lp] * 3 + [4 * chunks * 64 * 64, 2 * chunks * 64 * 64]
    assert buf.dtype == torch.uint8 and buf.numel() == sum(sizes)
    assert ptrs == [buf.data_ptr() + sum(sizes[:i]) for i in range(5)]
    assert all((p - buf.data_ptr()) % 256 == 0 for p in ptrs)


# -- the route rule --------------------------------------------------------------


def _views(kind, dtype, B=1, S=37, H=80, G=1):
    """x, Bm, Cm as the Mamba2 block hands them over: ``conv`` slices one
    (B, S, H P + 2 G N) conv output (zamba2: row stride 5248 elements, B and C
    10240 and 10368 bytes in); ``contiguous`` three tensors; ``offset`` a
    conv output whose base is 2 bytes past 16-byte alignment; ``odd`` a
    conv output with one more column (odd row stride)."""
    di, n = H * 64, G * 64
    width = di + 2 * n + (1 if kind == "odd" else 0)
    if kind == "contiguous":
        return (torch.zeros(B, S, H, 64, dtype=dtype), torch.zeros(B, S, G, 64, dtype=dtype),
                torch.zeros(B, S, G, 64, dtype=dtype))
    flat = torch.zeros(B * S * width + 1, dtype=dtype)
    conv = (flat[1:] if kind == "offset" else flat[:-1]).view(B, S, width)
    return (conv[..., :di].unflatten(-1, (H, 64)), conv[..., di:di + n].unflatten(-1, (G, 64)),
            conv[..., di + n:di + 2 * n].unflatten(-1, (G, 64)))


@pytest.mark.parametrize("kind,dtype,route,accepted", [
    ("conv", torch.bfloat16, "tensor_cores", True),        # zamba2's views
    ("contiguous", torch.bfloat16, "tensor_cores", True),
    ("conv", torch.float32, "cuda_cores", True),           # float32 keeps its exact products
    ("contiguous", torch.float32, "cuda_cores", True),
    ("offset", torch.bfloat16, "tensor_cores", False),      # refused by the wrapper
    ("odd", torch.bfloat16, "tensor_cores", False),
])
def test_ssd_route_rule(kind, dtype, route, accepted):
    """The route follows the dtype; the wrapper accepts a view only with a
    16-byte aligned base and outer strides (``_build.check_inputs``), which
    is what the 16-byte cp.async copies of every row need, so no accepted
    view needs another route."""
    x, Bm, Cm = _views(kind, dtype)
    assert K.route(x) == route
    assert all(_build._aligned(t) for t in (x, Bm, Cm)) == accepted
    if kind == "conv":
        es = x.element_size()
        assert x.stride(1) * es % 16 == 0
        assert (Bm.data_ptr() - x.data_ptr()) % 16 == 0 and (Cm.data_ptr() - x.data_ptr()) % 16 == 0
