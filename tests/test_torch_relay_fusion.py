"""The port's counterpart of tests/test_relay_fusion.py, against
``repro_torch/offload/runtime.py`` (``_fusible``, ``_fuse_runs``,
``_fuse_frames``): relay-aware fusion, FLAG_SEG_SRC segments carry the true
origin of relayed ``_ham/forward`` inner frames through fused egress
batches.

A forwarder re-emits inner frames whose ``src_node`` is the *origin*, not
itself.  Pre-SEG_SRC, such frames could not fold into a fused frame (the
fused header has one src for all segments), so multi-hop topologies lost
the small-call fusion win exactly where it matters — at the fan-in relay.
These tests pin the segment layout (u32 origin prefix), the relay's
fold-at-flush behaviour, and the reply contract: the final target answers
the origin directly, never the relay.
"""

from __future__ import annotations

import pytest

import repro_torch.offload.demo_handlers  # noqa: F401 — registers demo/* at
#                            collection, before any test seals the registry
from repro_torch.comm.local import LocalFabric
from repro_torch.core.closure import f2f
from repro_torch.core.message import (
    FLAG_DYNAMIC,
    FLAG_FUSED,
    FLAG_SEG_SRC,
    FLAG_STATIC,
    HEADER_NBYTES,
    HEADER_STRUCT,
    SEG_SRC_NBYTES,
    SEG_SRC_STRUCT,
    encode_frame,
    iter_fused,
)
from repro_torch.core.registry import default_registry
from repro_torch.offload.api import OffloadDomain
from repro_torch.offload.runtime import FUSE_THRESHOLD, NodeRuntime


def _ready_registry():
    reg = default_registry()
    if not reg.initialised:
        reg.init()
    return reg


def _inline_runtime(node_id: int, num_nodes: int = 3) -> NodeRuntime:
    reg = _ready_registry()
    fab = LocalFabric(num_nodes)
    return NodeRuntime(node_id, fab.endpoint(node_id), reg.table, inline=True)


# -- segment layout ----------------------------------------------------------


def test_fuse_frames_prefixes_foreign_src_segments():
    """A frame whose src_node is not the fusing node becomes a FLAG_SEG_SRC
    segment: u32 true-origin prefix, original flags/msg_id/payload intact.
    Own frames stay plain segments — no prefix tax on the common case."""
    rt = _inline_runtime(node_id=1)
    key = rt.table.key_of("demo/empty_static")
    own = bytes(encode_frame(key, b"", src_node=1, msg_id=0,
                             flags=FLAG_STATIC))
    payload = b"\xaa" * 24
    foreign = bytes(encode_frame(key, payload, src_node=0, msg_id=7,
                                 flags=FLAG_DYNAMIC))

    fused = rt._fuse_frames([own, foreign])
    _, _, flags, _, src, _, _ = HEADER_STRUCT.unpack_from(fused, 0)
    assert flags & FLAG_FUSED
    assert src == 1  # outer header: the fusing node
    segs = list(iter_fused(memoryview(fused)[HEADER_NBYTES:]))
    assert len(segs) == 2

    k0, f0, m0, p0 = segs[0]
    assert (k0, m0) == (key, 0)
    assert not f0 & FLAG_SEG_SRC
    assert len(p0) == 0

    k1, f1, m1, p1 = segs[1]
    assert (k1, m1) == (key, 7)
    assert f1 & FLAG_SEG_SRC and f1 & FLAG_DYNAMIC
    (origin,) = SEG_SRC_STRUCT.unpack_from(p1, 0)
    assert origin == 0
    assert bytes(p1[SEG_SRC_NBYTES:]) == payload
    assert rt.stats["fused"] == 2


def test_fusible_accepts_foreign_src_not_large_or_fused():
    rt = _inline_runtime(node_id=1)
    key = rt.table.key_of("demo/empty_static")
    small_foreign = bytes(encode_frame(key, b"x" * 16, src_node=0,
                                       flags=FLAG_DYNAMIC))
    assert rt._fusible(small_foreign)
    big = bytes(encode_frame(key, b"x" * (FUSE_THRESHOLD + 1), src_node=1))
    assert not rt._fusible(big)
    already_fused = rt._fuse_frames([small_foreign, small_foreign])
    assert not rt._fusible(already_fused)


# -- env toggle --------------------------------------------------------------


def test_fuse_egress_env_toggle(monkeypatch):
    reg = _ready_registry()
    fab = LocalFabric(2)
    monkeypatch.setenv("HAM_FUSE_EGRESS", "0")
    rt = NodeRuntime(0, fab.endpoint(0), reg.table, inline=True)
    assert rt.fuse_egress is False
    monkeypatch.setenv("HAM_FUSE_EGRESS", "1")
    rt2 = NodeRuntime(1, fab.endpoint(1), reg.table, inline=True)
    assert rt2.fuse_egress is True


# -- end to end: host -> relay -> target -------------------------------------


def test_fused_forward_batch_folds_at_relay_and_executes():
    """One fused frame of K ``_ham/forward`` oneways hits the relay; the K
    re-emitted inner frames must leave the relay FUSED (stats['fused']
    grows by >= K there) and every inner call must execute exactly once at
    the target — counted by the mutating chaos/bump probe."""
    dom = OffloadDomain.local(3, inline_host=True)
    token = 918273
    k = 24
    try:
        relay_rt = dom._inproc[1]
        fused_before = relay_rt.stats["fused"]
        base = dom.sync(2, f2f("chaos/counts", token))

        bump = f2f("chaos/bump", token)
        inner = bytes(encode_frame(
            dom._table.key_of(bump.record.stable_name),
            bump.pack_payload(),
            src_node=dom.host_node,
            msg_id=0,  # oneway inner: no reply expected
            flags=FLAG_DYNAMIC,
        ))
        futs = dom.host.send_fused(1, [f2f("_ham/forward", 2, inner)] * k)
        for fut in futs:
            dom.host._inline_wait(fut, 30.0)
        # FIFO completion barrier on the relay->target link: the relayed
        # ping travels 1 -> 2 *behind* the fused inner batch
        dom.host._inline_wait(dom.relay(1, 2, f2f("_ham/ping", 0)), 30.0)

        # thread-fabric nodes share the process-wide counter dict
        assert dom.sync(2, f2f("chaos/counts", token)) == base + k
        assert relay_rt.stats["fused"] - fused_before >= k, (
            "relay re-emitted the inner frames unfused — relay-aware "
            "fusion is not folding foreign-src frames"
        )
    finally:
        dom.sync(2, f2f("chaos/reset", token))
        dom.shutdown()


def test_seg_src_requests_reply_to_true_origin():
    """Relayed inner frames carrying live msg_ids: the target decodes the
    FLAG_SEG_SRC origin and replies to the ORIGIN (host), not the relay —
    every host future resolves with its own call's result."""
    dom = OffloadDomain.local(3, inline_host=True)
    n = 12
    try:
        created = [dom.host.futures.create() for _ in range(n)]
        forwards = []
        for i, (msg_id, _fut) in enumerate(created):
            fn = f2f("demo/add", i, 7)
            inner = bytes(encode_frame(
                dom._table.key_of(fn.record.stable_name),
                fn.pack_payload(),
                src_node=dom.host_node,
                msg_id=msg_id,
                flags=FLAG_DYNAMIC,
            ))
            forwards.append(f2f("_ham/forward", 2, inner))
        outer = dom.host.send_fused(1, forwards)
        results = [dom.host._inline_wait(fut, 30.0) for _, fut in created]
        assert results == [i + 7 for i in range(n)]
        for fut in outer:  # the forward oneway-acks themselves
            dom.host._inline_wait(fut, 30.0)
        assert dom._inproc[1].stats["fused"] >= n
    finally:
        dom.shutdown()


def test_relay_reply_routing_unfused_baseline():
    """The pre-fusion relay contract still holds for singleton forwards:
    request host -> via -> dst, reply dst -> host directly."""
    dom = OffloadDomain.local(3, inline_host=True)
    try:
        futs = [dom.relay(1, 2, f2f("demo/add", i, 100)) for i in range(8)]
        got = [dom.host._inline_wait(f, 30.0) for f in futs]
        assert got == [i + 100 for i in range(8)]
    finally:
        dom.shutdown()


# -- guard: fused relay must not over-execute under retry flags --------------


@pytest.mark.chaos
def test_relayed_fused_bumps_execute_exactly_once():
    """Exactly-once witness at fusion density: 4 fused forward batches of
    the same mutating probe; the cluster-wide counter total must equal the
    number of logical calls (no duplication through the SEG_SRC path)."""
    dom = OffloadDomain.local(3, inline_host=True)
    token = 424242
    batches, per_batch = 4, 16
    try:
        base = dom.sync(2, f2f("chaos/counts", token))
        bump = f2f("chaos/bump", token)
        inner = bytes(encode_frame(
            dom._table.key_of(bump.record.stable_name),
            bump.pack_payload(),
            src_node=dom.host_node,
            msg_id=0,
            flags=FLAG_DYNAMIC,
        ))
        for _ in range(batches):
            futs = dom.host.send_fused(
                1, [f2f("_ham/forward", 2, inner)] * per_batch
            )
            for fut in futs:
                dom.host._inline_wait(fut, 30.0)
        dom.host._inline_wait(dom.relay(1, 2, f2f("_ham/ping", 0)), 30.0)
        total = dom.sync(2, f2f("chaos/counts", token))
        assert total == base + batches * per_batch
    finally:
        dom.sync(2, f2f("chaos/reset", token))
        dom.shutdown()
