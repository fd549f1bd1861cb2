"""The port's xLSTM slice against the reference, on the CPU: the mLSTM
kernel's plain version against the Pallas kernel in interpret mode, the
ragged-S path against the exact recurrence, the cells and blocks, the
reduced xlstm-1.3b model on the reference's own parameters, and the serving
engine token for token.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances (float32 unless stated):
* same algorithm, same chunking (plain version vs Pallas kernel, cells,
  blocks, model logits): 1e-4 — sums are taken in another order (the
  Pallas kernel's cumsum is a triangular matmul, its q is scaled by a
  product where the model divides);
* against the recurrence (another chunking): h 5e-4 / rtol 1e-3 and C
  5e-3 / rtol 1e-2, as ``tests/test_kernels.py`` holds the Pallas kernel;
* bfloat16: 2e-2 / rtol 1e-2 (one bf16 rounding of O(1) values).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_reduced
from repro.kernels import ops as jops
from repro.kernels.mlstm import mlstm_chunked_kernel
from repro.models import xlstm as JX
from repro.models.api import build_model as jax_build
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServingEngine as JServingEngine
from repro_torch.configs import get_reduced
from repro_torch.kernels import mlstm as K
from repro_torch.kernels import ops, ref
from repro_torch.models import xlstm as X
from repro_torch.models.api import build_model
from repro_torch.models.convert import cache_from_numpy, params_from_numpy
from repro_torch.serve.engine import Request, ServingEngine

ARCH = "xlstm-1.3b"
ATOL = 1e-4


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.asarray(x, np.float32)).to(dtype)


def _close(port, ref, atol=ATOL, rtol=1e-4):
    np.testing.assert_allclose(port.float().numpy(), np.asarray(ref, np.float32),
                               atol=atol, rtol=rtol)


def _close_tree(port, ref, atol=ATOL, rtol=1e-4):
    for a, b in zip(jax.tree_util.tree_leaves(port), jax.tree_util.tree_leaves(ref)):
        assert tuple(a.shape) == b.shape
        _close(a, b, atol, rtol)


def _mlstm_inputs(rng, lead, S, dk, dv):
    """q, k, v, i_pre, f_pre (numpy float32) with lead dims ``lead`` before
    and after S: kernel layout (BH,) or model layout (B, S, H)."""
    def n(*shape):
        return rng.standard_normal(shape, np.float32)

    B, H = lead
    if H is None:   # kernel layout (BH, S, d)
        return n(B, S, dk), n(B, S, dk), n(B, S, dv), n(B, S), n(B, S) + 2.0
    return (n(B, S, H, dk), n(B, S, H, dk), n(B, S, H, dv), n(B, S, H),
            n(B, S, H) + 2.0)


def _state(rng, lead, dk, dv):
    """A nonzero (C, n, m): C ~ N(0, 1), n > 0, m ~ N(0, 1)."""
    return (rng.standard_normal((*lead, dk, dv), np.float32),
            np.abs(rng.standard_normal((*lead, dk), np.float32)) + 0.5,
            rng.standard_normal(lead, np.float32))


# -- the kernel's plain version ---------------------------------------------


@pytest.mark.parametrize("with_state", [False, True], ids=["empty", "state"])
@pytest.mark.parametrize("BH,nc,chunk,dk,dv", [
    (1, 1, 8, 8, 8),
    (2, 3, 8, 16, 32),
    (3, 2, 16, 8, 32),
    (4, 4, 16, 16, 8),
])
def test_mlstm_plain_matches_pallas(BH, nc, chunk, dk, dv, with_state):
    rng = np.random.default_rng(BH * 10 + nc)
    S = nc * chunk
    xs = _mlstm_inputs(rng, (BH, None), S, dk, dv)
    st = _state(rng, (BH,), dk, dv) if with_state else None
    h, (C, n, m) = mlstm_chunked_kernel(
        *map(jnp.asarray, xs), None if st is None else tuple(map(jnp.asarray, st)),
        chunk=chunk, interpret=True)
    tst = None if st is None else tuple(map(_t, st))
    got_h, (got_C, got_n, got_m) = K.mlstm_chunked_plain(*map(_t, xs), tst, chunk=chunk)
    _close(got_h, h)
    _close(got_C, C, rtol=1e-4)
    _close(got_n, n)
    _close(got_m, m)
    # the kernel-layout dispatcher takes the plain version for CPU tensors
    before = K.launches
    h2, _ = K.mlstm_chunked(*map(_t, xs), tst, chunk=chunk)
    assert torch.equal(h2, got_h) and K.launches == before


@pytest.mark.parametrize("with_state", [False, True], ids=["empty", "state"])
@pytest.mark.parametrize("S", [37, 13, 40])
def test_mlstm_ragged_length_matches_recurrence(S, with_state):
    """S = 37 and 13 with chunk 8: the reference's divisor rule runs chunk 1
    on the CPU; S = 40 runs five chunks of 8."""
    rng = np.random.default_rng(S)
    B, H, dk, dv = 2, 2, 8, 16
    xs = _mlstm_inputs(rng, (B, H), S, dk, dv)
    st = _state(rng, (B, H), dk, dv) if with_state else None
    hr, (Cr, nr, mr) = JX.mlstm_recurrent(
        *map(jnp.asarray, xs), None if st is None else tuple(map(jnp.asarray, st)))
    h, (C, n, m) = ops.mlstm_chunked(*map(_t, xs), None if st is None else tuple(map(_t, st)),
                                     chunk=8)
    assert h.shape == (B, S, H, dv) and C.dtype == torch.float32
    _close(h, hr, 5e-4, 1e-3)
    _close(C, Cr, 5e-3, 1e-2)
    _close(n, nr, 5e-3, 1e-2)
    _close(m, mr, 1e-4)


def test_ragged_tail_masking_is_exact():
    """The CUDA kernel pads the last chunk with q = k = v = 0, log-forget 0
    and input gate -inf; on the chunked math that padding changes neither h
    nor the final state (checked here with the plain chunked form at a chunk
    the reference's rule would never pick)."""
    rng = np.random.default_rng(5)
    B, S, H, dk, dv, chunk = 2, 37, 2, 8, 16, 8
    q, k, v, i, f = map(_t, _mlstm_inputs(rng, (B, H), S, dk, dv))
    pad = 40 - S

    def padded(a, fill):
        return torch.cat([a, a.new_full((B, pad, *a.shape[2:]), fill)], dim=1)

    h, (C, n, m) = X.mlstm_chunked(padded(q, 0.0), padded(k, 0.0), padded(v, 0.0),
                                   padded(i, -float("inf")), padded(f, float("inf")),
                                   chunk=chunk)
    hr, (Cr, nr, mr) = ref.mlstm_recurrent_ref(q, k, v, i, f)
    _close(h[:, :S], hr, 5e-4, 1e-3)
    _close(C, Cr, 5e-3, 1e-2)
    _close(n, nr, 5e-3, 1e-2)
    _close(m, mr)


@pytest.mark.parametrize("with_state", [False, True], ids=["empty", "state"])
def test_ops_mlstm_chunked_matches_pallas_ops(with_state):
    """Model layout (B, S, H, d), the reference's ``ops.mlstm_chunked`` in
    interpret mode against the port's."""
    rng = np.random.default_rng(11)
    B, S, H, dk, dv = 2, 32, 2, 8, 16
    xs = _mlstm_inputs(rng, (B, H), S, dk, dv)
    st = _state(rng, (B, H), dk, dv) if with_state else None
    h, stj = jops.mlstm_chunked(*map(jnp.asarray, xs),
                                None if st is None else tuple(map(jnp.asarray, st)),
                                chunk=8, interpret=True)
    got_h, got_st = ops.mlstm_chunked(*map(_t, xs), None if st is None else tuple(map(_t, st)),
                                      chunk=8)
    _close(got_h, h)
    _close_tree(got_st, stj)


def test_mlstm_chunked_bf16_matches_reference_model():
    """bfloat16 inputs: q is scaled in bf16 before the upcast on both
    sides, h is rounded to bf16 once."""
    rng = np.random.default_rng(3)
    xs = _mlstm_inputs(rng, (2, 2), 24, 8, 16)
    h, (C, _, _) = JX.mlstm_chunked(*(jnp.asarray(x, jnp.bfloat16) for x in xs), chunk=8)
    got_h, (got_C, _, _) = ops.mlstm_chunked(*(_t(x, torch.bfloat16) for x in xs), chunk=8)
    assert got_h.dtype == torch.bfloat16 and got_C.dtype == torch.float32
    _close(got_h, h.astype(jnp.float32), 2e-2, 1e-2)
    _close(got_C, C, 2e-2, 1e-2)


# -- cells and blocks ----------------------------------------------------------


def test_causal_conv_and_step():
    rng = np.random.default_rng(0)
    w = rng.standard_normal((4, 6), np.float32)
    x = rng.standard_normal((2, 9, 6), np.float32)
    _close(X.causal_conv({"w": _t(w)}, _t(x), torch.float32),
           JX.causal_conv({"w": jnp.asarray(w)}, jnp.asarray(x), jnp.float32), 1e-6)
    state = rng.standard_normal((2, 3, 6), np.float32)
    out, st = X.causal_conv_step({"w": _t(w)}, _t(x[:, :1]), _t(state), torch.float32)
    jout, jst = JX.causal_conv_step({"w": jnp.asarray(w)}, jnp.asarray(x[:, :1]),
                                    jnp.asarray(state), jnp.float32)
    _close(out, jout, 1e-6)
    _close(st, jst, 0.0)


def test_mlstm_step_matches_reference_in_place():
    rng = np.random.default_rng(1)
    B, H, dk, dv = 3, 2, 8, 16
    xs = _mlstm_inputs(rng, (B, H), 1, dk, dv)
    st = _state(rng, (B, H), dk, dv)
    jh, jst = JX.mlstm_step(*map(jnp.asarray, xs), tuple(map(jnp.asarray, st)))
    tst = tuple(map(_t, st))
    h, out = X.mlstm_step(*map(_t, xs), tst)
    assert all(a is b for a, b in zip(out, tst))   # updated in place
    _close(h, jh)
    _close_tree(tst, jst)


def test_slstm_cell_matches_reference():
    rng = np.random.default_rng(2)
    B, H, dh = 3, 4, 8
    d = H * dh
    gx = rng.standard_normal((B, 4 * d), np.float32)
    r = rng.standard_normal((4, H, dh, dh), np.float32) / np.sqrt(dh)
    st = (rng.standard_normal((B, d), np.float32), rng.standard_normal((B, d), np.float32),
          np.abs(rng.standard_normal((B, d), np.float32)),
          rng.standard_normal((B, d), np.float32))
    ref = JX._slstm_cell(jnp.asarray(gx), tuple(map(jnp.asarray, st)), jnp.asarray(r))
    got = X._slstm_cell(_t(gx), tuple(map(_t, st)), _t(r))
    _close_tree(got, ref)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_block_prefill_then_decode_matches_reference(kind):
    """One block on reference params: prefill of 11 positions (its state,
    conv tail included), then two decode steps from that state."""
    jcfg, cfg = jax_reduced(ARCH), get_reduced(ARCH)
    init = JX.mlstm_block_init if kind == "mlstm" else JX.slstm_block_init
    japply = JX.mlstm_block_apply if kind == "mlstm" else JX.slstm_block_apply
    apply = X.mlstm_block_apply if kind == "mlstm" else X.slstm_block_apply
    jp = init(jax.random.PRNGKey(4), jcfg)
    p = params_from_numpy(_np(jp), cfg, "cpu")
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 11, cfg.d_model), np.float32)
    jy, jst = japply(jp, jnp.asarray(x), jcfg)
    y, st = apply(p, _t(x), cfg)
    _close(y, jy)
    _close_tree(st, jst)
    for _ in range(2):
        xt = rng.standard_normal((2, 1, cfg.d_model), np.float32)
        jy, jst = japply(jp, jnp.asarray(xt), jcfg, state=jst, decode=True)
        y, st = apply(p, _t(xt), cfg, state=st, decode=True)
        _close(y, jy)
        _close_tree(st, jst)


# -- the reduced model ---------------------------------------------------------


@pytest.fixture(scope="module")
def pair():
    jm = jax_build(jax_reduced(ARCH))
    jp = jm.init(jax.random.PRNGKey(0))
    cfg = get_reduced(ARCH)
    m = build_model(cfg, device="cpu")
    return jm, jp, m, params_from_numpy(_np(jp), cfg, "cpu")


def test_params_carry_across(pair):
    _, jp, _, p = pair
    flat, _ = jax.tree_util.tree_flatten_with_path(_np(jp))
    for path, leaf in flat:
        node = p
        for k in path:
            node = node[k.key]
        assert tuple(node.shape) == leaf.shape and node.dtype == torch.float32
        np.testing.assert_array_equal(node.numpy(), leaf)


@pytest.mark.parametrize("T", [11, 16])
def test_prefill_logits_and_cache(pair, T):
    """T = 11 is prime above the chunk (8); T = 16 is two chunks."""
    jm, jp, m, p = pair
    tokens = np.random.default_rng(T).integers(0, m.cfg.vocab_size, (2, T))
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(tokens)})
    tl, tc = m.prefill(p, {"tokens": torch.from_numpy(tokens)})
    _close(tl, jl)
    assert set(tc) == {"mlstm", "slstm"} and len(tc["mlstm"]) == 4 and len(tc["slstm"]) == 5
    for leaf, jleaf in zip(jax.tree_util.tree_leaves(tc), jax.tree_util.tree_leaves(jc)):
        assert leaf.dtype == getattr(torch, jleaf.dtype.name)
    _close_tree(tc, jc)


def test_decode_from_empty_cache_matches_reference(pair):
    """12 decode steps from the initial state, logits per step against the
    reference's (tests/test_models.py:76-94 runs the same loop)."""
    jm, jp, m, p = pair
    tokens = np.random.default_rng(7).integers(0, m.cfg.vocab_size, (2, 12))
    jcache = jm.init_cache(2, 12)
    tcache = cache_from_numpy(_np(jcache), m.cfg, "cpu")
    fresh = m.init_cache(2, 12)
    _close_tree(fresh, jcache, 0.0, 0.0)   # the port's own initial state is the reference's
    for t in range(12):
        step = {"tokens": jnp.asarray(tokens[:, t:t + 1]), "pos": jnp.asarray(t, jnp.int32)}
        jl, jcache = jm.decode_step(jp, jcache, step)
        tl, out = m.decode_step(p, tcache, {"tokens": torch.from_numpy(tokens[:, t:t + 1]),
                                            "pos": torch.tensor(t)})
        assert out is tcache and tl.shape == (2, 1, m.cfg.vocab_size)
        _close(tl, jl)
    _close_tree(tcache, jcache)


def test_prefill_then_decode_matches_reference(pair):
    jm, jp, m, p = pair
    rng = np.random.default_rng(8)
    tokens = rng.integers(0, m.cfg.vocab_size, (2, 9))
    _, jcache = jm.prefill(jp, {"tokens": jnp.asarray(tokens)})
    tcache = cache_from_numpy(_np(jcache), m.cfg, "cpu")
    for _ in range(3):
        step = rng.integers(0, m.cfg.vocab_size, (2, 1))
        jl, jcache = jm.decode_step(jp, jcache, {"tokens": jnp.asarray(step),
                                                 "pos": jnp.asarray(0, jnp.int32)})
        tl, _ = m.decode_step(p, tcache, {"tokens": torch.from_numpy(step),
                                          "pos": torch.tensor(0)})
        _close(tl, jl)
    _close_tree(tcache, jcache)


def test_cache_from_numpy_keeps_float32_states():
    """A bf16 conversion keeps the cell states float32 (mLSTM C, n, m; sLSTM
    c, n, m) and casts the conv states and the sLSTM h."""
    jcache = jax_build(jax_reduced(ARCH)).init_cache(2, 8)
    tc = cache_from_numpy(_np(jcache), get_reduced(ARCH), "cpu", dtype=torch.bfloat16)
    assert [t.dtype for t in tc["mlstm"]] == [torch.float32] * 3 + [torch.bfloat16]
    assert [t.dtype for t in tc["slstm"]] == [torch.bfloat16] + [torch.float32] * 3 + [
        torch.bfloat16]
    assert tc["mlstm"][2].max().item() == np.float32(-1e30)


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_port_init_builds_reference_tree(param_dtype):
    """The port's own seeded init: the reference's shapes, every leaf in
    ``param_dtype``, the gate biases as the reference sets them."""
    import dataclasses

    cfg = dataclasses.replace(get_reduced(ARCH), param_dtype=param_dtype)
    jshapes = jax.eval_shape(jax_build(jax_reduced(ARCH)).init, jax.random.PRNGKey(0))
    p = build_model(cfg, device="cpu").init(seed=3)
    flat, _ = jax.tree_util.tree_flatten_with_path(jshapes)
    for path, leaf in flat:
        node = p
        for k in path:
            node = node[k.key]
        assert tuple(node.shape) == leaf.shape and node.dtype == getattr(torch, param_dtype)
    H, d = cfg.num_heads, cfg.d_model
    np.testing.assert_allclose(p["mlstm"]["b_if"][0, 1].float().numpy(),
                               np.concatenate([np.zeros(H), np.linspace(3.0, 6.0, H)]), rtol=1e-2)
    assert (p["slstm"]["b_gates"][0, 0, d:2 * d] == 3.0).all()
    assert torch.equal(p["mlstm"]["wq"], build_model(cfg, device="cpu").init(seed=3)["mlstm"]["wq"])


# -- the serving engine ----------------------------------------------------------


def _reqs(specs, cls):
    return [cls(prompt=(np.arange(n) * 7 + i) % 128, max_new_tokens=k)
            for i, (n, k) in enumerate(specs)]


@pytest.mark.parametrize("num_slots,specs", [
    (2, [(11, 4), (5, 6), (13, 3), (1, 5)]),   # 11, 13: primes above the chunk
    (3, [(13, 5), (8, 3), (11, 6), (2, 2)]),
])
def test_serving_token_identical_to_reference(pair, num_slots, specs):
    jm, jp, m, p = pair
    out = ServingEngine(m, p, num_slots=num_slots, max_len=32, device="cpu").run(
        _reqs(specs, Request))
    ref = JServingEngine(jm, jp, num_slots=num_slots, max_len=32).run(_reqs(specs, JRequest))
    assert out == ref


@pytest.mark.parametrize("block", [4, 3])
def test_step_many_matches_sequential_steps(pair, block):
    _, _, m, p = pair

    def serve(k):
        eng = ServingEngine(m, p, num_slots=2, max_len=32, device="cpu")
        eng.admit(Request(prompt=np.arange(11) % 128, max_new_tokens=5, rid=0), 0)
        eng.admit(Request(prompt=np.arange(6) % 128, max_new_tokens=9, rid=1), 1)
        while any(r is not None for r in eng.slot_req):
            eng.step_many(k) if k > 1 else eng.step()
        return eng.outputs

    assert serve(block) == serve(1)


def test_admission_overwrites_an_evicted_lane(pair):
    """A slot evicted mid-decode holds a stale state; the next admission
    overwrites its whole lane of every state leaf, and the other lane is
    left as it was."""
    _, _, m, p = pair
    eng = ServingEngine(m, p, num_slots=2, max_len=32, device="cpu")
    eng.admit(Request(prompt=np.arange(9) % 128, max_new_tokens=8, rid=0), 0)
    eng.admit(Request(prompt=np.arange(5) % 128, max_new_tokens=8, rid=1), 1)
    for _ in range(3):
        eng.step()
    assert eng.evict(0)
    other = [t[:, :, 1].clone() for t in jax.tree_util.tree_leaves(eng.payload["cache"])]
    prompt = (np.arange(13) * 3) % 128
    eng.admit(Request(prompt=prompt, max_new_tokens=4, rid=2), 0)
    _, fresh = m.prefill(p, {"tokens": torch.from_numpy(prompt[None])})
    leaves = jax.tree_util.tree_leaves(eng.payload["cache"])
    for leaf, want, keep in zip(leaves, jax.tree_util.tree_leaves(fresh), other):
        assert torch.equal(leaf[:, :, 0], want[:, :, 0])
        assert torch.equal(leaf[:, :, 1], keep)
