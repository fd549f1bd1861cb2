"""The port's counterpart of tests/test_migratable.py.

Serialisation invariants: roundtrip identity over arbitrary pytrees."""

import numpy as np
import pytest
from _hypothesis_compat import given, settings, st
from _hypothesis_compat import hnp

from repro_torch.core import errors as ham
from repro_torch.core import migratable as mig

# -- strategies --------------------------------------------------------------

_scalars = st.one_of(
    st.booleans(),
    st.integers(min_value=-(2**62), max_value=2**62),
    st.floats(allow_nan=False, allow_infinity=False, width=64),
    st.text(max_size=24),
    st.binary(max_size=64),
    st.none(),
)

_arrays = hnp.arrays(
    dtype=st.sampled_from([np.float32, np.float64, np.int32, np.int64,
                           np.uint8, np.bool_]),
    shape=hnp.array_shapes(max_dims=3, max_side=5),
)

_trees = st.recursive(
    st.one_of(_scalars, _arrays),
    lambda children: st.one_of(
        st.lists(children, max_size=4),
        st.tuples(children, children),
        st.dictionaries(st.text(max_size=8), children, max_size=4),
    ),
    max_leaves=12,
)


def _eq(a, b):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        aa, bb = np.asarray(a), np.asarray(b)
        if aa.dtype != bb.dtype:
            return False
        # bitwise roundtrip: NaNs compare equal (payloads are verbatim)
        eq_nan = aa.dtype.kind in "fc"
        return np.array_equal(aa, bb, equal_nan=eq_nan)
    if isinstance(a, (list, tuple)):
        return (type(a) == type(b) and len(a) == len(b)
                and all(_eq(x, y) for x, y in zip(a, b)))
    if isinstance(a, dict):
        return (isinstance(b, dict) and a.keys() == b.keys()
                and all(_eq(a[k], b[k]) for k in a))
    return a == b and type(a) == type(b)


# -- dynamic path -------------------------------------------------------------


@settings(max_examples=120, deadline=None)
@given(_trees)
def test_dynamic_roundtrip(tree):
    assert _eq(mig.unpack_dynamic(mig.pack_dynamic(tree)), tree)


def test_dynamic_trailing_bytes_rejected():
    payload = mig.pack_dynamic([1, 2]) + b"\x00"
    with pytest.raises(ham.MigratableError):
        mig.unpack_dynamic(payload)


# -- static path --------------------------------------------------------------


@settings(max_examples=80, deadline=None)
@given(st.lists(st.one_of(
    st.integers(min_value=-(2**62), max_value=2**62),
    st.floats(allow_nan=False, allow_infinity=False, width=64),
    st.booleans(),
    hnp.arrays(dtype=st.sampled_from([np.float32, np.int64]),
               shape=hnp.array_shapes(max_dims=2, max_side=6)),
), min_size=1, max_size=5))
def test_static_roundtrip(args):
    args = tuple(args)
    specs = tuple(mig.spec_of(a) for a in args)
    payload = mig.pack_static(args, specs)
    assert len(payload) == mig.static_payload_nbytes(specs)
    out = mig.unpack_static(payload, specs)
    assert all(_eq(np.asarray(a) if isinstance(a, np.ndarray) else a,
                   np.asarray(b) if isinstance(b, np.ndarray) else b)
               for a, b in zip(args, out))


def test_static_spec_mismatch_raises():
    spec = (mig.spec_of(np.zeros((4,), np.float32)),)
    with pytest.raises(ham.SpecMismatchError):
        mig.pack_static((np.zeros((5,), np.float32),), spec)
    with pytest.raises(ham.SpecMismatchError):
        mig.pack_static((np.zeros((4,), np.float64),), spec)


def test_not_bitwise_migratable_raises():
    class Foo:
        pass

    with pytest.raises(ham.NotBitwiseMigratableError):
        mig.spec_of(Foo())
    with pytest.raises(ham.NotBitwiseMigratableError):
        mig.pack_dynamic(Foo())


class _Scaled:
    """A value that needs a codec: int8 codes and one float32 scale."""

    def __init__(self, codes, scale):
        self.codes, self.scale = codes, scale


mig.register_migratable(
    _Scaled,
    lambda v: np.float32(v.scale).tobytes() + v.codes.astype(np.int8).tobytes(),
    lambda b: _Scaled(np.frombuffer(b[4:], np.int8).copy(),
                      float(np.frombuffer(b[:4], np.float32)[0])),
    type_name="test:scaled",
)


def test_custom_codec_roundtrip():
    x = np.random.default_rng(0).standard_normal(128).astype(np.float32)
    scale = float(np.abs(x).max() / 127)
    value = _Scaled(np.round(x / scale).astype(np.int8), scale)
    out = mig.unpack_dynamic(mig.pack_dynamic(value))
    assert isinstance(out, _Scaled)
    np.testing.assert_array_equal(out.codes, value.codes)
    np.testing.assert_allclose(out.codes * out.scale, x, atol=scale)


def test_compressed_tensor_codec_roundtrip():
    """The reference's codec case, over the ported ``CompressedTensor``
    (registered under the reference's type name): its frame is the
    reference's, byte for byte, and decodes in either package."""
    from repro.core import migratable as ref_mig
    from repro.optim.compression import CompressedTensor as RefCompressed
    from repro_torch.optim.compression import CompressedTensor

    x = np.random.default_rng(0).standard_normal((16, 8)).astype(np.float32)
    ct = CompressedTensor.compress(x)
    frame = mig.pack_dynamic(ct)
    out = mig.unpack_dynamic(frame)
    assert isinstance(out, CompressedTensor)
    np.testing.assert_allclose(out.decompress(), x, atol=ct.scale)
    assert frame == ref_mig.pack_dynamic(RefCompressed.compress(x))
    ref_out = ref_mig.unpack_dynamic(frame)
    assert isinstance(ref_out, RefCompressed)
    np.testing.assert_array_equal(ref_out.q, ct.q)


def test_buffer_ptr_is_fixed_size_static():
    from repro_torch.offload.buffer import BufferPtr

    ptr = BufferPtr(3, 42, 1024, epoch=2)
    spec = mig.spec_of(ptr)
    payload = mig.pack_static((ptr,), (spec,))
    assert len(payload) == 32  # node + handle + nbytes + epoch, all i64
    (out,) = mig.unpack_static(payload, (spec,))
    assert out == ptr


def test_scan_locality_weights_by_nbytes():
    """The locality-policy regression (ROADMAP item): one byte-heavy buffer
    must outvote many tiny ones — votes weigh data, not pointer count."""
    from repro_torch.offload.buffer import BufferPtr

    small = [BufferPtr(1, h, 8) for h in (1, 2, 3)]       # 24 B on node 1
    big = BufferPtr(2, 9, 100 * 1024 * 1024)              # 100 MB on node 2
    votes = mig.scan_locality((big, *small))
    assert votes[2] > votes[1]
    assert votes == {1: 24, 2: 100 * 1024 * 1024}
    # unknown-size pointers still vote, with unit weight
    assert mig.scan_locality((BufferPtr(5, 1),)) == {5: 1}


def test_scan_locality_depth_bound():
    """Containers nested past MAX_SCAN_DEPTH are not descended — the same
    bound the directory's resolve_args rewrite walk applies, so a pointer
    deep enough to vote is always deep enough to be rewritten."""
    from repro_torch.offload.buffer import BufferPtr

    ptr = BufferPtr(3, 11, 64)
    at_bound = ptr
    for _ in range(mig.MAX_SCAN_DEPTH):  # ptr sits at depth MAX_SCAN_DEPTH
        at_bound = [at_bound]
    assert mig.scan_locality((at_bound,)) == {3: 64}
    past_bound = [at_bound]
    assert mig.scan_locality((past_bound,)) == {}
