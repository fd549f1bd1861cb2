"""The port's counterpart of tests/test_registry.py.

Registry determinism — the paper's core guarantee (§5.2)."""

import pytest
from _hypothesis_compat import given, settings, st

from repro_torch.core import errors as ham
from repro_torch.core.migratable import spec_of
from repro_torch.core.registry import HandlerRegistry, verify_peer_digest


def _noop():
    pass


def _ident(x):
    return x


def _mk(names):
    reg = HandlerRegistry()
    for n in names:
        reg.register(_noop, name=n)
    return reg.init()


@settings(max_examples=50, deadline=None)
@given(st.permutations([f"h/{i:03d}" for i in range(24)]))
def test_key_map_independent_of_registration_order(perm):
    """Any registration order yields the identical key map (the
    communication-free agreement that heterogeneous processes rely on)."""
    base = _mk(sorted(perm))
    other = _mk(list(perm))
    assert base.digest == other.digest
    for name in perm:
        assert base.key_of(name) == other.key_of(name)


@settings(max_examples=50, deadline=None)
@given(st.sets(st.sampled_from([f"h/{i:03d}" for i in range(40)]),
               min_size=1, max_size=40))
def test_digest_detects_different_handler_sets(subset):
    full = _mk([f"h/{i:03d}" for i in range(40)])
    part = _mk(sorted(subset))
    if len(subset) == 40:
        assert part.digest == full.digest
    else:
        assert part.digest != full.digest


def test_keys_are_dense_sorted_indices():
    table = _mk(["b", "a", "c"])
    assert [table.key_of(n) for n in ("a", "b", "c")] == [0, 1, 2]
    assert table.handler_at(0).stable_name.startswith("a")


def test_lambda_rejected_without_explicit_name():
    reg = HandlerRegistry()
    with pytest.raises(ham.UnstableNameError):
        reg.register(lambda: 1)


def test_local_function_rejected():
    reg = HandlerRegistry()

    def local_fn():
        return 2

    with pytest.raises(ham.UnstableNameError):
        reg.register(local_fn)
    # explicit name (the l2f route) works
    reg.register(local_fn, name="explicit/name")
    assert reg.init().key_of("explicit/name") == 0


def test_name_collision_with_different_functions():
    reg = HandlerRegistry()
    reg.register(_noop, name="dup")
    with pytest.raises(ham.RegistryError):
        reg.register(lambda: 2, name="dup")


def test_sealed_registry_rejects_late_registration():
    reg = HandlerRegistry()
    reg.register(_noop, name="x")
    reg.init()
    with pytest.raises(ham.RegistrySealedError):
        reg.register(_noop, name="y")


def test_elastic_reinit_allows_late_registration():
    reg = HandlerRegistry()
    reg.register(_noop, name="x")
    t1 = reg.init(allow_late_registration=True)
    reg.register(_noop, name="y")
    t2 = reg.reinit()  # keeps the late-registration mode
    assert len(t2) == 2 and t1.digest != t2.digest
    reg.register(_noop, name="z")  # still allowed after reinit
    assert len(reg.reinit()) == 3


def test_unknown_key_raises():
    table = _mk(["only"])
    with pytest.raises(ham.UnknownHandlerError):
        table.handler_at(5)


def test_peer_digest_verification():
    a = _mk(["h/1", "h/2"])
    b = _mk(["h/1", "h/2"])
    c = _mk(["h/1"])
    verify_peer_digest(a, b.digest)
    with pytest.raises(ham.KeyMapMismatchError):
        verify_peer_digest(a, c.digest)


def test_static_spec_part_of_identity():
    import numpy as np

    reg1 = HandlerRegistry()
    reg1.register(_ident, name="h", arg_specs=(spec_of(np.zeros(4)),))
    reg2 = HandlerRegistry()
    reg2.register(_ident, name="h", arg_specs=(spec_of(np.zeros(8)),))
    assert reg1.init().digest != reg2.init().digest


def test_read_only_is_routing_metadata_not_identity():
    """read_only feeds sender-side routing (replica serving) only: it must
    not change the stable name or the key-map digest peers agree on."""
    reg_a, reg_b = HandlerRegistry(), HandlerRegistry()
    reg_a.register(_noop, name="x/fn")
    reg_b.register(_noop, name="x/fn", read_only=True)
    ta, tb = reg_a.init(), reg_b.init()
    assert ta.digest == tb.digest
    assert ta.record_of("x/fn").read_only is False
    assert tb.record_of("x/fn").read_only is True
