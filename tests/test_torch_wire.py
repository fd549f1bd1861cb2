"""One wire between two packages: the port's HAM runtime (``repro_torch``)
against the reference's (``repro``), byte for byte, with no process.

HAM's heterogeneous claim is that two builds of the same source agree on
every key and every byte without talking.  Here the two builds are two
packages: the port keeps its own copies of the wire modules, and these
tests hold each copy to the reference — the wire-constant table (the
cross-package form of hamlint's HAM004 drift check, which knows only
``repro/core/flags.py``), frames for every flag combination, static and
dynamic payloads in both directions, torch tensors as array leaves, the
compiled plans' sizes, and the serving handler table's names, keys and
digest.
"""

import numpy as np
import pytest
import torch
from _hypothesis_compat import given, hnp, settings, st

import repro.cluster.pool as ref_pool
import repro.core.flags as ref_flags
import repro.core.message as ref_msg
import repro.core.migratable as ref_mig
import repro.core.registry as ref_registry
import repro.offload.runtime as ref_runtime
import repro.serve.handlers as ref_handlers
import repro_torch.cluster.pool as port_pool
import repro_torch.core.flags as port_flags
import repro_torch.core.message as port_msg
import repro_torch.core.migratable as port_mig
import repro_torch.core.registry as port_registry
import repro_torch.core.wireplan as port_wireplan
import repro_torch.offload.runtime as port_runtime
import repro_torch.serve.handlers as port_handlers
from repro_torch.core.errors import MigratableError

# -- wire constants -----------------------------------------------------------


def _public(module):
    return {k: v for k, v in vars(module).items()
            if k.isupper() and not k.startswith("_")}


def test_wire_constant_table_equals_reference():
    """Every public constant of the reference's table has the same value in
    the port's; the port adds only the bit-position table its sentinels are
    derived from."""
    ref, port = _public(ref_flags), _public(port_flags)
    assert set(port) - set(ref) == {"MSG_ID_BITS"}
    assert {k: port[k] for k in ref} == ref
    for name, bit in port_flags.MSG_ID_BITS.items():
        assert getattr(ref_flags, name) == 1 << bit


def test_message_reexports_equal_reference():
    ref = {k: v for k, v in _public(ref_msg).items() if isinstance(v, int)}
    port = {k: v for k, v in _public(port_msg).items() if isinstance(v, int)}
    assert port == ref
    assert port_msg.HEADER_STRUCT.format == ref_msg.HEADER_STRUCT.format
    assert port_runtime.ReplayCache.FLUSH == ref_runtime.ReplayCache.FLUSH


# -- frames ---------------------------------------------------------------------


ALL_FLAGS = range(1 << len(ref_flags.FLAG_BITS))


@pytest.mark.parametrize("payload", [b"", b"\x01\x02\x03", bytes(range(256)) * 9],
                         ids=["empty", "small", "2304B"])
def test_frames_byte_identical_for_every_flag_combination(payload):
    for flags in ALL_FLAGS:
        args = dict(src_node=3, msg_id=(flags << 40) | 17, flags=flags)
        ref = bytes(ref_msg.encode_frame(11, payload, **args))
        port = bytes(port_msg.encode_frame(11, payload, **args))
        assert port == ref, flags
        header, view = port_msg.split_frame(ref)
        assert (header.flags, header.key, bytes(view)) == (flags, 11, payload)
        header, view = ref_msg.split_frame(port)
        assert (header.flags, header.key, bytes(view)) == (flags, 11, payload)


# -- static payloads (the specs tests/test_migratable.py draws) ----------------


_static_args = st.lists(st.one_of(
    st.integers(min_value=-(2**62), max_value=2**62),
    st.floats(allow_nan=False, allow_infinity=False, width=64),
    st.booleans(),
    hnp.arrays(dtype=st.sampled_from([np.float32, np.int64]),
               shape=hnp.array_shapes(max_dims=2, max_side=6)),
), min_size=1, max_size=5)


def _canonical(specs):
    """A spec tuple's wire identity (each package has its own spec classes)."""
    return "(" + ",".join(s.canonical() for s in specs) + ")"


def _same(a, b):
    if isinstance(a, np.ndarray):   # bitwise: a NaN travels verbatim
        return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()
    return a == b and type(a) is type(b)


@pytest.mark.parametrize("direction", ["ref_to_port", "port_to_ref"])
@settings(max_examples=60, deadline=None)
@given(args=_static_args)
def test_pack_static_crosses_packages(direction, args):
    args = tuple(args)
    src, dst = (ref_mig, port_mig) if direction == "ref_to_port" else (port_mig, ref_mig)
    specs = tuple(src.spec_of(a) for a in args)
    dst_specs = tuple(dst.spec_of(a) for a in args)
    assert _canonical(dst_specs) == _canonical(specs)
    payload = bytes(src.pack_static(args, specs))
    assert bytes(dst.pack_static(args, dst_specs)) == payload
    out = dst.unpack_static(payload, dst_specs)
    assert all(_same(a, b) for a, b in zip(args, out))


# -- dynamic payloads ------------------------------------------------------------


_trees = st.recursive(
    st.one_of(
        st.booleans(), st.none(), st.text(max_size=12), st.binary(max_size=24),
        st.integers(min_value=-(2**62), max_value=2**62),
        st.floats(allow_nan=False, allow_infinity=False, width=64),
        hnp.arrays(dtype=st.sampled_from([np.float32, np.float64, np.int32, np.int64,
                                          np.uint8, np.bool_]),
                   shape=hnp.array_shapes(max_dims=3, max_side=4)),
    ),
    lambda children: st.one_of(
        st.lists(children, max_size=4),
        st.tuples(children, children),
        st.dictionaries(st.text(max_size=8), children, max_size=4),
    ),
    max_leaves=10,
)


@settings(max_examples=80, deadline=None)
@given(tree=_trees)
def test_pack_dynamic_byte_identical(tree):
    ref = ref_mig.pack_dynamic(tree)
    assert port_mig.pack_dynamic(tree) == ref
    assert port_mig.pack_dynamic(ref_mig.unpack_dynamic(ref)) == ref
    assert ref_mig.pack_dynamic(port_mig.unpack_dynamic(ref)) == ref


# -- torch tensors as array leaves ------------------------------------------------


TENSORS = {
    "float32": lambda: torch.arange(24, dtype=torch.float32).reshape(2, 3, 4) / 7,
    "int64": lambda: torch.arange(-5, 7, dtype=torch.int64),
    "int32": lambda: torch.arange(12, dtype=torch.int32).reshape(3, 4),
    "bool": lambda: torch.arange(6) % 2 == 0,
    "float16": lambda: torch.linspace(-2, 2, 9, dtype=torch.float16),
    "transposed": lambda: torch.arange(12, dtype=torch.float64).reshape(3, 4).t(),
    "requires_grad": lambda: torch.ones(3, requires_grad=True),
    "scalar": lambda: torch.tensor(3.5),
}


@pytest.mark.parametrize("name", list(TENSORS))
def test_cpu_tensor_packs_as_its_numpy_view(name):
    """A CPU tensor is the reference's ``_T_NDARRAY`` leaf: the dtype
    string, shape and bytes of its numpy view, statically and dynamically;
    it decodes as an ndarray on either side."""
    t = TENSORS[name]()
    view = t.detach().numpy()
    assert port_mig.spec_of(t).canonical() == ref_mig.spec_of(view).canonical()
    ref_dyn = ref_mig.pack_dynamic([view, {"t": view}])
    assert port_mig.pack_dynamic([t, {"t": t}]) == ref_dyn
    out = ref_mig.unpack_dynamic(port_mig.pack_dynamic(t))
    assert isinstance(out, np.ndarray) and out.dtype == view.dtype
    np.testing.assert_array_equal(out, view)
    want = bytes(ref_mig.pack_static((view,), (ref_mig.spec_of(view),)))
    specs = (port_mig.spec_of(t),)
    assert bytes(port_mig.pack_static((t,), specs)) == want
    plan = port_wireplan.compile_plan(specs)
    buf = bytearray(plan.nbytes)
    plan.pack_args(buf, 0, (t,))
    assert bytes(buf) == want


def test_bfloat16_tensor_leaf_raises():
    t = torch.ones(4, dtype=torch.bfloat16)
    with pytest.raises(MigratableError, match="bfloat16"):
        port_mig.pack_dynamic(t)
    with pytest.raises(MigratableError, match="bfloat16"):
        port_mig.spec_of(t)


# -- compiled plans and the serving handler table -------------------------------


def _serving_registry(registry_mod, runtime_mod, pool_mod, handlers_mod):
    """The registry ``ClusterServingEngine`` builds (internal, cluster with
    the data plane, and serve sets), made explicitly: a test worker's
    default registry holds whatever other test files imported."""
    reg = registry_mod.HandlerRegistry()
    runtime_mod.register_internal_handlers(reg)
    pool_mod.register_cluster_handlers(reg)
    handlers_mod.register_serve_handlers(reg)
    return reg.init()


@pytest.fixture(scope="module")
def tables():
    return (_serving_registry(ref_registry, ref_runtime, ref_pool, ref_handlers),
            _serving_registry(port_registry, port_runtime, port_pool, port_handlers))


def test_serving_handler_table_names_keys_digest_equal(tables):
    ref, port = tables
    names = [r.stable_name for r in ref]
    assert [r.stable_name for r in port] == names
    assert [port.key_of(n) for n in names] == [ref.key_of(n) for n in names]
    assert port.digest == ref.digest
    port_registry.verify_peer_digest(port, ref.digest)
    assert any(n.startswith("_serve/admit_stream") for n in names)
    assert [(r.read_only, r.mutates) for r in port] == [(r.read_only, r.mutates) for r in ref]


def test_compiled_plans_equal(tables):
    ref, port = tables
    for plans in ("arg_plans", "result_plans"):
        sizes = [None if p is None else (p.nbytes, _canonical(p.specs))
                 for p in getattr(ref, plans)]
        assert [None if p is None else (p.nbytes, _canonical(p.specs))
                for p in getattr(port, plans)] == sizes
        if plans == "arg_plans":
            assert any(size is not None for size in sizes)


SERVE_CALLS = {
    "_serve/admit_stream": lambda h: (h.pad_prompt(np.arange(40)), 40, 7, 1, 64, 0.0, 2.5),
    "_serve/stream": lambda h: (1, 7, 1, 3, 50321, 0, 2),
    "_serve/stream_block": lambda h: (2, 7, 1, 4, 3, np.pad(np.arange(3, dtype=np.int32),
                                                           (0, 29)), 1, 0),
    "_serve/cancel": lambda h: (7, 1, 2),
}


@pytest.mark.parametrize("name", list(SERVE_CALLS))
def test_serve_static_payloads_cross_packages(tables, name):
    """A serving call packed by one package's compiled plan unpacks under
    the other's, both ways, to the same values."""
    ref, port = tables
    ref_plan = ref.arg_plans[ref.key_of(name)]
    port_plan = port.arg_plans[port.key_of(name)]
    args = SERVE_CALLS[name](port_handlers)
    a, b = bytearray(ref_plan.nbytes), bytearray(port_plan.nbytes)
    ref_plan.pack_args(a, 0, args)
    port_plan.pack_args(b, 0, args)
    assert a == b
    for plan, buf in ((port_plan, a), (ref_plan, b)):
        out = plan.unpack_args(memoryview(buf))
        assert all(_same(np.asarray(x) if isinstance(x, np.ndarray) else x,
                         np.asarray(y) if isinstance(y, np.ndarray) else y)
                   for x, y in zip(out, args))
