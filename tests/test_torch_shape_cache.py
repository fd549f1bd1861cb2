"""The port's counterpart of tests/test_shape_cache.py.

Shape-keyed WirePlan cache: signature grammar, LRU behaviour, wire
byte-parity with the static packer, end-to-end value equality with the
cache on and off, and concurrent shape churn.

The cache (``repro_torch.core.wireplan.ShapeCache``) lets dynamic calls whose
argument shapes repeat ride a compiled plan (``FLAG_SHAPED``) instead of
per-leaf TLV — the signature on the wire fully determines the plan, so
both sides compile the same codec independently (the same-source
assumption the paper leans on, extended to shapes discovered at runtime).
"""

from __future__ import annotations

import threading

import numpy as np
import pytest

import repro_torch.offload.demo_handlers  # noqa: F401 — registers demo/* at
#                            collection, before any test seals the registry
from repro_torch.core.errors import MigratableError
from repro_torch.core.migratable import ArraySpec, ScalarSpec, pack_static, spec_of
from repro_torch.core.wireplan import (
    ShapeCache,
    pack_shaped,
    parse_signature,
    spec_signature,
)

# -- signature grammar -------------------------------------------------------


def test_signature_roundtrip_scalars_and_arrays():
    specs = (ScalarSpec("i8"), ScalarSpec("f8"),
             ArraySpec((2, 3), "float64"), ScalarSpec("b1"))
    for arity in ("A", "V", "T"):
        sig = spec_signature(specs, arity)
        got_arity, got_specs = parse_signature(sig)
        assert got_arity == arity
        assert got_specs == specs


def test_signature_is_ascii_and_stable():
    specs = (ScalarSpec("i8"), ArraySpec((4,), "int32"))
    sig = spec_signature(specs, "A")
    assert sig == spec_signature(specs, "A")  # deterministic
    sig.decode("ascii")  # wire bytes stay ascii — header-debugger friendly


@pytest.mark.parametrize("bad", [
    b"",                      # empty
    b"Z(scalar[i8])",         # unknown arity
    b"Ascalar[i8]",           # no parens
    b"A(scalar[zz])",         # unknown scalar kind
    b"A(scalar[i8],junk)",    # unparseable leaf => rebuild mismatch
    b"A(scalar[i8])x",        # trailing garbage
])
def test_malformed_signatures_rejected(bad):
    with pytest.raises(MigratableError):
        parse_signature(bad)


# -- cache behaviour ---------------------------------------------------------


def test_hit_miss_and_eviction_counters():
    cache = ShapeCache(maxsize=4)
    # 6 distinct shapes through a 4-entry cache: evictions must fire
    for n in range(6):
        assert cache.for_values((np.zeros(n + 1),), "A") is not None
    stats = cache.stats()
    assert stats["misses"] == 6
    assert stats["evictions"] == 2
    assert stats["send_entries"] == 4
    # the most recent shape is still resident => hit
    assert cache.for_values((np.zeros(6),), "A") is not None
    assert cache.stats()["hits"] == 1
    # the evicted oldest shape re-misses (and re-evicts)
    cache.for_values((np.zeros(1),), "A")
    assert cache.stats()["misses"] == 7


def test_fast_key_and_spec_path_agree_on_signature():
    """Plain int rides the fast key, np.int64 rides the spec_of path; both
    must map onto the same wire signature (they are the same i8 scalar)."""
    cache = ShapeCache()
    sig_fast, _ = cache.for_values((7,), "A")
    sig_spec, _ = cache.for_values((np.int64(7),), "A")
    assert sig_fast == sig_spec


def test_unspeccable_values_fall_back_to_none():
    cache = ShapeCache()
    assert cache.for_values(("a string",), "A") is None
    assert cache.for_values(([1, 2],), "A") is None
    assert cache.for_values((b"bytes",), "A") is None
    # mixed: ONE bad leaf poisons the whole tuple (TLV carries it all)
    assert cache.for_values((1, "x"), "A") is None


def test_for_result_arities():
    cache = ShapeCache()
    assert cache.for_result(None) is None          # None => TLV
    sig_v, _ = cache.for_result(3.5)               # bare value => "V"
    assert sig_v.startswith(b"V")
    sig_t, _ = cache.for_result((1, 2.0))          # tuple => "T"
    assert sig_t.startswith(b"T")


# -- wire parity -------------------------------------------------------------


def test_shaped_payload_packed_section_matches_pack_static():
    """The plan-packed section of a FLAG_SHAPED payload must be
    byte-identical to the legacy ``pack_static`` encoding of the same
    values under the same specs — the receiver's compiled plan and a
    pre-plan decoder must agree on every byte."""
    values = (3, 2.5, np.arange(6, dtype=np.float64).reshape(2, 3))
    specs = tuple(spec_of(v) for v in values)
    cache = ShapeCache()
    sig, plan = cache.for_values(values, "A")
    payload = pack_shaped(sig, plan, values)
    packed_section = bytes(payload[2 + len(sig):])
    assert packed_section == bytes(pack_static(list(values), specs))


def test_unpack_shaped_roundtrip():
    values = (1, 2.0, np.ones((3, 2), dtype=np.int32))
    cache = ShapeCache()
    sig, plan = cache.for_values(values, "A")
    out = cache.unpack_shaped(bytes(pack_shaped(sig, plan, values)),
                              expect_args=True)
    assert out[0] == 1 and out[1] == 2.0
    np.testing.assert_array_equal(out[2], values[2])
    # reply-side arity convention: V unwraps to the bare value
    sig_v, plan_v = cache.for_result(4.25)
    assert cache.unpack_shaped(
        bytes(pack_shaped(sig_v, plan_v, (4.25,))), expect_args=False
    ) == 4.25


# -- end-to-end: cache on vs off ---------------------------------------------


def _domain_result(shape_cache: bool):
    from repro_torch.core.closure import f2f
    from repro_torch.core.registry import default_registry
    from repro_torch.offload.api import OffloadDomain

    reg = default_registry()
    if not reg.initialised:
        reg.init()
    dom = OffloadDomain.local(2, inline_host=True)
    # flip BOTH ends in-process (local domain shares the process)
    dom.host._shape_cache = ShapeCache() if shape_cache else None
    for w in dom._local_workers:
        w._shape_cache = ShapeCache() if shape_cache else None
    try:
        call = f2f("demo/add", np.arange(4.0), np.full(4, 2.0))
        return [dom.sync(1, call) for _ in range(3)]
    finally:
        dom.shutdown()


def test_end_to_end_values_identical_cache_on_and_off():
    on = _domain_result(shape_cache=True)
    off = _domain_result(shape_cache=False)
    for a, b in zip(on, off):
        np.testing.assert_array_equal(a, b)


def test_env_toggle_disables_cache(monkeypatch):
    from repro_torch.core.registry import default_registry
    from repro_torch.offload.api import OffloadDomain

    reg = default_registry()
    if not reg.initialised:
        reg.init()
    monkeypatch.setenv("HAM_SHAPE_CACHE", "0")
    dom = OffloadDomain.local(2, inline_host=True)
    try:
        assert dom.host._shape_cache is None
    finally:
        dom.shutdown()
    monkeypatch.setenv("HAM_SHAPE_CACHE", "1")
    dom = OffloadDomain.local(2, inline_host=True)
    try:
        assert dom.host._shape_cache is not None
    finally:
        dom.shutdown()


# -- concurrency -------------------------------------------------------------


def test_concurrent_shape_churn_keeps_cache_consistent():
    """8 threads hammer a 8-entry cache with 32 distinct shapes: every
    lookup must return a usable (sig, plan) pair that round-trips its own
    values, and the entry counts must never exceed the bound — under
    constant eviction racing with lookups."""
    cache = ShapeCache(maxsize=8)
    shapes = [(i % 32) + 1 for i in range(256)]
    errors: list = []

    def churn(tid: int) -> None:
        try:
            for n in shapes:
                values = (tid, float(n), np.zeros(n))
                ent = cache.for_values(values, "A")
                assert ent is not None
                sig, plan = ent
                out = cache.unpack_shaped(
                    bytes(pack_shaped(sig, plan, values)), expect_args=True
                )
                assert out[0] == tid and out[1] == float(n)
                assert len(out[2]) == n
        except Exception as e:  # noqa: BLE001 — surfaced by the main thread
            errors.append(e)

    threads = [threading.Thread(target=churn, args=(t,)) for t in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not errors, errors[:3]
    stats = cache.stats()
    assert stats["send_entries"] <= 8
    assert stats["recv_entries"] <= 8
    assert stats["evictions"] > 0
