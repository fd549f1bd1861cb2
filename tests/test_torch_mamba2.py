"""The port's Mamba2/Zamba2 slice against the reference, on the CPU: the SSD
kernel's plain version against the Pallas kernel in interpret mode, the
model-layout wrapper against the reference model's one-rounding
``ssd_chunked``, ragged S against the exact recurrence, the masked ragged
tail, the decode step, the Mamba2 block, the reduced zamba2-2.7b on the
reference's own parameters, and the serving engine token for token.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances (float32 unless stated):
* same algorithm, same chunking (plain version vs Pallas kernel, step,
  block, model logits): 1e-4 — sums are taken in another order (the Pallas
  kernel's cumsum is a triangular matmul);
* against the recurrence (another chunking): y 5e-4 / rtol 1e-3 and h
  5e-3 / rtol 1e-2, as ``tests/test_kernels.py`` holds the Pallas kernel;
* bfloat16: 2e-2 / rtol 1e-2 (one bf16 rounding of O(1) values).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_reduced
from repro.kernels.mamba2_ssd import ssd_chunked_kernel
from repro.models import mamba2 as JM
from repro.models.api import build_model as jax_build
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServingEngine as JServingEngine
from repro_torch.configs import get_reduced
from repro_torch.kernels import mamba2_ssd as K
from repro_torch.kernels import ops, ref
from repro_torch.models import mamba2 as M
from repro_torch.models import zamba2 as Z
from repro_torch.models.api import build_model
from repro_torch.models.convert import cache_from_numpy, params_from_numpy
from repro_torch.serve.engine import Request, ServingEngine

ARCH = "zamba2-2.7b"
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


def _ssd_inputs(rng, B, S, H, G, N, P):
    """x (B,S,H,P), dt (B,S,H) in the softplus range of the model, A (H,) < 0,
    Bm/Cm (B,S,G,N), D (H,): numpy float32."""
    def n(*shape):
        return rng.standard_normal(shape, np.float32)

    dt = np.log1p(np.exp(n(B, S, H) - 2.0)).astype(np.float32)
    A = -np.linspace(1.0, 16.0, H, dtype=np.float32)
    return n(B, S, H, P), dt, A, n(B, S, G, N), n(B, S, G, N), n(H)


def _state(rng, B, H, N, P):
    return rng.standard_normal((B, H, N, P), np.float32)


# -- the kernel's plain version ---------------------------------------------


@pytest.mark.parametrize("with_state", [False, True], ids=["empty", "state"])
@pytest.mark.parametrize("B,nc,chunk,H,G,N,P", [
    (1, 1, 8, 2, 1, 8, 8),
    (2, 3, 8, 4, 2, 8, 16),
    (2, 2, 16, 4, 1, 16, 8),
    (1, 4, 16, 6, 2, 8, 8),
])
def test_ssd_plain_matches_pallas(B, nc, chunk, H, G, N, P, with_state):
    """Kernel layout on the Pallas side: B/C repeated per head, log lambda
    precomputed, no D (the reference wrapper adds it); D = 0 here."""
    rng = np.random.default_rng(B * 10 + nc)
    S = nc * chunk
    x, dt, A, Bm, Cm, _ = _ssd_inputs(rng, B, S, H, G, N, P)
    h0 = _state(rng, B, H, N, P) if with_state else None
    hpg = H // G
    heads = lambda a: a.transpose(0, 2, 1, 3).reshape(B * H, S, -1)
    y, hN = ssd_chunked_kernel(
        jnp.asarray(heads(x)), jnp.asarray(dt.transpose(0, 2, 1).reshape(B * H, S)),
        jnp.asarray((A * dt).transpose(0, 2, 1).reshape(B * H, S)),
        jnp.asarray(heads(np.repeat(Bm, hpg, axis=2))), jnp.asarray(heads(np.repeat(Cm, hpg, axis=2))),
        None if h0 is None else jnp.asarray(h0.reshape(B * H, N, P)), chunk=chunk, interpret=True)
    want_y = np.asarray(y).reshape(B, H, S, P).transpose(0, 2, 1, 3)
    args = (_t(x), _t(dt), _t(A), _t(Bm), _t(Cm), torch.zeros(H))
    tst = None if h0 is None else _t(h0)
    got_y, got_h = K.ssd_chunked_plain(*args, tst, chunk=chunk)
    assert got_y.shape == (B, S, H, P) and got_h.dtype == torch.float32
    _close(got_y, want_y)
    _close(got_h, np.asarray(hN).reshape(B, H, N, P))
    # the dispatcher takes the plain version for CPU tensors, launching nothing
    before = K.launches
    y2, _ = K.ssd_chunked(*args, tst, chunk=chunk)
    assert torch.equal(y2, got_y) and K.launches == before


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_state", [False, True], ids=["empty", "state"])
def test_ops_ssd_chunked_matches_reference_model(with_state, dtype):
    """The model-layout wrapper against the reference model's own
    ``ssd_chunked``: D x added in float32, y rounded once (the reference's
    kernel wrapper rounds y and then adds D x)."""
    rng = np.random.default_rng(11)
    B, S, H, G, N, P = 2, 32, 4, 2, 8, 8
    x, dt, A, Bm, Cm, D = _ssd_inputs(rng, B, S, H, G, N, P)
    h0 = _state(rng, B, H, N, P) if with_state else None
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    y, h = JM.ssd_chunked(jnp.asarray(x, jdt), jnp.asarray(dt), jnp.asarray(A),
                          jnp.asarray(Bm, jdt), jnp.asarray(Cm, jdt), jnp.asarray(D),
                          None if h0 is None else jnp.asarray(h0), chunk=8)
    got_y, got_h = ops.ssd_chunked(_t(x, tdt), _t(dt), _t(A), _t(Bm, tdt), _t(Cm, tdt), _t(D),
                                   None if h0 is None else _t(h0), chunk=8)
    assert got_y.dtype == tdt and got_h.dtype == torch.float32
    tol = (ATOL, 1e-4) if dtype == "float32" else (2e-2, 1e-2)
    _close(got_y, y.astype(jnp.float32), *tol)
    _close(got_h, h, *tol)


@pytest.mark.parametrize("with_state", [False, True], ids=["empty", "state"])
@pytest.mark.parametrize("S", [37, 13, 40])
def test_ssd_ragged_length_matches_recurrence(S, with_state):
    """S = 37 and 13 with chunk 8: the reference's divisor rule runs chunk 1
    on the CPU; S = 40 runs five chunks of 8."""
    rng = np.random.default_rng(S)
    B, H, G, N, P = 2, 4, 2, 8, 8
    xs = _ssd_inputs(rng, B, S, H, G, N, P)
    h0 = _state(rng, B, H, N, P) if with_state else None
    yr, hr = JM.ssd_recurrent(*map(jnp.asarray, xs), None if h0 is None else jnp.asarray(h0))
    y, h = ops.ssd_chunked(*map(_t, xs), None if h0 is None else _t(h0), chunk=8)
    assert y.shape == (B, S, H, P)
    _close(y, yr, 5e-4, 1e-3)
    _close(h, hr, 5e-3, 1e-2)


def test_ssd_ragged_tail_masking_is_exact():
    """The CUDA kernel pads the last chunk with x = B = C = 0 and dt = 0 (log
    decay 0, weight 0); on the chunked math that padding changes neither y
    nor the final state (checked with the plain chunked form at a chunk the
    reference's rule would never pick), and the padded rows come out 0."""
    rng = np.random.default_rng(5)
    B, S, H, G, N, P, chunk = 2, 37, 4, 2, 8, 8, 8
    x, dt, A, Bm, Cm, D = map(_t, _ssd_inputs(rng, B, S, H, G, N, P))
    h0 = _t(_state(rng, B, H, N, P))
    pad = 40 - S

    def padded(a):
        return torch.cat([a, a.new_zeros((B, pad, *a.shape[2:]))], dim=1)

    y, h = M.ssd_chunked(padded(x), padded(dt), A, padded(Bm), padded(Cm), D, h0, chunk=chunk)
    yr, hr = ref.ssd_recurrent_ref(x, dt, A, Bm, Cm, D, h0)
    assert torch.equal(y[:, S:], torch.zeros_like(y[:, S:]))
    _close(y[:, :S], yr, 5e-4, 1e-3)
    _close(h, hr, 5e-3, 1e-2)
    # and the same as the reference's own chunking of the unpadded input
    yd, hd = K.ssd_chunked_plain(x, dt, A, Bm, Cm, D, h0, chunk=chunk)
    _close(y[:, :S], yd, 5e-4, 1e-3)
    _close(h, hd, 5e-3, 1e-2)


def test_ssd_step_matches_reference_in_place():
    rng = np.random.default_rng(1)
    B, H, G, N, P = 3, 4, 2, 8, 8
    xs = _ssd_inputs(rng, B, 1, H, G, N, P)
    h0 = _state(rng, B, H, N, P)
    jy, jh = JM.ssd_step(*map(jnp.asarray, xs), jnp.asarray(h0))
    th = _t(h0)
    y, out = M.ssd_step(*map(_t, xs), th)
    assert out is th   # updated in place
    _close(y, jy)
    _close(th, jh)


@pytest.mark.parametrize("T", [11, 2])
def test_block_prefill_then_decode_matches_reference(T):
    """One Mamba2 block on reference params: prefill of T positions (its
    state, conv tail included; T = 2 < width - 1 left-pads the tail), then
    two decode steps from that state."""
    jcfg, cfg = jax_reduced(ARCH), get_reduced(ARCH)
    jp = JM.mamba2_block_init(jax.random.PRNGKey(4), jcfg)
    p = params_from_numpy(_np(jp), cfg, "cpu")
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, T, cfg.d_model), np.float32)
    jy, jst = JM.mamba2_block_apply(jp, jnp.asarray(x), jcfg)
    y, st = M.mamba2_block_apply(p, _t(x), cfg)
    _close(y, jy)
    _close_tree(st, jst)
    for _ in range(2):
        xt = rng.standard_normal((2, 1, cfg.d_model), np.float32)
        jy, jst = JM.mamba2_block_apply(jp, jnp.asarray(xt), jcfg, state=jst, decode=True)
        h = st[0]
        y, st = M.mamba2_block_apply(p, _t(xt), cfg, state=st, decode=True)
        assert st[0] is h   # the SSM state is updated in place
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
    assert set(tc) == {"mamba", "attn_kv"} and len(tc["mamba"]) == 2
    for leaf, jleaf in zip(jax.tree_util.tree_leaves(tc), jax.tree_util.tree_leaves(jc)):
        assert leaf.dtype == getattr(torch, jleaf.dtype.name)
    _close_tree(tc, jc)


def test_decode_from_empty_cache_matches_reference(pair):
    """12 decode steps from the initial cache, logits per step against the
    reference's, and the whole cache after them."""
    jm, jp, m, p = pair
    tokens = np.random.default_rng(7).integers(0, m.cfg.vocab_size, (2, 12))
    jcache = jm.init_cache(2, 12)
    tcache = cache_from_numpy(_np(jcache), m.cfg, "cpu")
    _close_tree(m.init_cache(2, 12), jcache, 0.0, 0.0)   # the port's own zero cache
    for t in range(12):
        step = {"tokens": jnp.asarray(tokens[:, t:t + 1]), "pos": jnp.asarray(t, jnp.int32)}
        jl, jcache = jm.decode_step(jp, jcache, step)
        tl, out = m.decode_step(p, tcache, {"tokens": torch.from_numpy(tokens[:, t:t + 1]),
                                            "pos": torch.tensor(t)})
        assert out is tcache and tl.shape == (2, 1, m.cfg.vocab_size)
        _close(tl, jl)
    _close_tree(tcache, jcache)


def test_prefill_then_per_slot_decode_matches_reference(pair):
    """A prefilled cache carried across, then per-slot positions (one lane
    behind the other), as the engine decodes."""
    jm, jp, m, p = pair
    rng = np.random.default_rng(8)
    tokens = rng.integers(0, m.cfg.vocab_size, (2, 9))
    _, jpre = jm.prefill(jp, {"tokens": jnp.asarray(tokens)})
    jcache = jm.init_cache(2, 16)
    jcache = {"mamba": jpre["mamba"],
              "attn_kv": {n: jcache["attn_kv"][n].at[:, :, :9].set(jpre["attn_kv"][n])
                          for n in ("k", "v")}}
    tcache = cache_from_numpy(_np(jcache), m.cfg, "cpu")
    pos = np.array([9, 6], np.int32)
    for _ in range(3):
        step = rng.integers(0, m.cfg.vocab_size, (2, 1))
        jl, jcache = jm.decode_step(jp, jcache, {"tokens": jnp.asarray(step),
                                                 "pos": jnp.asarray(pos)})
        tl, _ = m.decode_step(p, tcache, {"tokens": torch.from_numpy(step),
                                          "pos": torch.from_numpy(pos)})
        _close(tl, jl)
        pos = pos + 1
    _close_tree(tcache, jcache)


def test_cache_from_numpy_keeps_float32_state():
    """A bf16 conversion keeps the SSM state h float32 and casts the conv
    states and the KV caches."""
    jcache = jax_build(jax_reduced(ARCH)).init_cache(2, 8)
    tc = cache_from_numpy(_np(jcache), get_reduced(ARCH), "cpu", dtype=torch.bfloat16)
    assert [t.dtype for t in tc["mamba"]] == [torch.float32, torch.bfloat16]
    assert tc["attn_kv"]["k"].dtype == tc["attn_kv"]["v"].dtype == torch.bfloat16


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_port_init_builds_reference_tree(param_dtype):
    """The port's own seeded init: the reference's shapes, every leaf in
    ``param_dtype`` but A_log, dt_bias and D (float32, as the reference
    makes them), A_log and dt_bias in the reference's ranges."""
    cfg = dataclasses.replace(get_reduced(ARCH), param_dtype=param_dtype)
    jshapes = jax.eval_shape(jax_build(jax_reduced(ARCH)).init, jax.random.PRNGKey(0))
    p = build_model(cfg, device="cpu").init(seed=3)
    flat, _ = jax.tree_util.tree_flatten_with_path(jshapes)
    for path, leaf in flat:
        node = p
        for k in path:
            node = node[k.key]
        f32 = path[-1].key in ("A_log", "dt_bias", "D")
        assert tuple(node.shape) == leaf.shape
        assert node.dtype == (torch.float32 if f32 else getattr(torch, param_dtype))
    H = M.mamba2_dims(cfg)[1]
    np.testing.assert_allclose(p["mamba"]["A_log"][1, 0].numpy(),
                               np.log(np.linspace(1.0, 16.0, H)), rtol=1e-6)
    dt0 = torch.nn.functional.softplus(p["mamba"]["dt_bias"])
    assert ((dt0 > 0.99e-3) & (dt0 < 1.01e-1)).all()
    assert torch.equal(p["mamba"]["w_in"], build_model(cfg, device="cpu").init(seed=3)["mamba"]["w_in"])


def test_attention_window_not_ported():
    """The windowed shared block is ported now (``test_torch_window.py``
    holds it against the reference): a config with ``attn_window`` builds,
    and its KV cache is a ring of min(max_len, window) slots."""
    cfg = get_reduced(ARCH)
    windowed = dataclasses.replace(cfg, ssm=dataclasses.replace(cfg.ssm, attn_window=8))
    assert Z.zamba2_init_cache(windowed, 1, 32, device="cpu")["attn_kv"]["k"].shape[2] == 8
    assert Z.zamba2_init_cache(windowed, 1, 5, device="cpu")["attn_kv"]["k"].shape[2] == 5
    p = build_model(windowed, device="cpu").init(seed=0)
    assert torch.equal(p["mamba"]["w_in"], build_model(cfg, device="cpu").init(seed=0)["mamba"]["w_in"])


# -- the serving engine ----------------------------------------------------------


def _reqs(specs, cls):
    return [cls(prompt=(np.arange(n) * 7 + i) % 128, max_new_tokens=k)
            for i, (n, k) in enumerate(specs)]


@pytest.mark.parametrize("num_slots,specs", [
    (2, [(11, 4), (5, 6), (13, 3), (1, 5)]),   # 11, 13: primes above the chunk
    (3, [(13, 5), (5, 3), (11, 6), (1, 2)]),
])
def test_serving_token_identical_to_reference(pair, num_slots, specs):
    jm, jp, m, p = pair
    out = ServingEngine(m, p, num_slots=num_slots, max_len=32, device="cpu").run(
        _reqs(specs, Request))
    ref_out = JServingEngine(jm, jp, num_slots=num_slots, max_len=32).run(_reqs(specs, JRequest))
    assert out == ref_out


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
    """A slot evicted mid-decode holds a stale state and KV prefix; the next
    admission overwrites its whole SSM and conv lane (axis 2) and its KV
    prefix (axis 1), and leaves the other lane as it was."""
    _, _, m, p = pair
    eng = ServingEngine(m, p, num_slots=2, max_len=32, device="cpu")
    eng.admit(Request(prompt=np.arange(9) % 128, max_new_tokens=8, rid=0), 0)
    eng.admit(Request(prompt=np.arange(5) % 128, max_new_tokens=8, rid=1), 1)
    for _ in range(3):
        eng.step()
    assert eng.evict(0)
    cache = eng.payload["cache"]
    leaves = [(leaf, 2) for leaf in cache["mamba"]] + [
        (cache["attn_kv"][n], 1) for n in ("k", "v")]
    other = [leaf.select(axis, 1).clone() for leaf, axis in leaves]
    prompt = (np.arange(13) * 3) % 128
    eng.admit(Request(prompt=prompt, max_new_tokens=4, rid=2), 0)
    _, fresh = m.prefill(p, {"tokens": torch.from_numpy(prompt[None])})
    want = [(fresh["mamba"][i], 2) for i in range(2)] + [(fresh["attn_kv"][n], 1)
                                                           for n in ("k", "v")]
    for (leaf, axis), (w, _), keep in zip(leaves, want, other):
        lane = leaf.select(axis, 0)
        src = w.select(axis, 0)
        assert torch.equal(lane[tuple(slice(0, n) for n in src.shape)], src)
        assert torch.equal(leaf.select(axis, 1), keep)
