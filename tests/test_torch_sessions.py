"""The port's counterpart of tests/test_sessions.py.

SessionRouter: rendezvous-hash invariants + the stickiness contract.

The properties asserted here are the module-level contract of
``repro_torch.cluster.sessions`` — minimal remap on grow, exact restore on
shrink-back, pins that survive unrelated membership changes and re-place
only on their own worker's departure.
"""

from repro_torch.cluster.sessions import SessionRouter, rendezvous_hash

KEYS = [f"session-{i}" for i in range(400)]


def test_hrw_deterministic_and_total():
    nodes = [1, 2, 3]
    first = {k: rendezvous_hash(k, nodes) for k in KEYS}
    again = {k: rendezvous_hash(k, nodes) for k in KEYS}
    assert first == again  # stable hash, not Python's salted hash()
    assert set(first.values()) == {1, 2, 3}  # every node gets keys
    counts = [sum(1 for v in first.values() if v == n) for n in nodes]
    assert min(counts) > len(KEYS) // 10  # roughly balanced


def test_hrw_grow_remaps_only_fair_share():
    before = {k: rendezvous_hash(k, [1, 2, 3]) for k in KEYS}
    after = {k: rendezvous_hash(k, [1, 2, 3, 4]) for k in KEYS}
    moved = [k for k in KEYS if before[k] != after[k]]
    # every moved key moved TO the new node — nothing reshuffles between
    # survivors (the rendezvous property elastic resize relies on)
    assert all(after[k] == 4 for k in moved)
    # and the moved share is about 1/4
    assert 0.10 < len(moved) / len(KEYS) < 0.45


def test_hrw_shrink_restores_exactly():
    before = {k: rendezvous_hash(k, [1, 2, 3]) for k in KEYS}
    grown = {k: rendezvous_hash(k, [1, 2, 3, 4]) for k in KEYS}
    shrunk = {k: rendezvous_hash(k, [1, 2, 3]) for k in KEYS}
    assert shrunk == before
    # keys that never moved to 4 keep the same owner through the resize
    assert all(grown[k] == before[k] for k in KEYS if grown[k] != 4)


def test_router_pins_stick_across_unrelated_resize():
    live = {1, 2, 3}
    router = SessionRouter(lambda: sorted(live))
    placement = {k: router.route(k) for k in KEYS[:50]}
    live.add(4)  # grow: pinned sessions must NOT move (HRW alone would
    #              remap ~1/4 of them — the pin table is the stickiness)
    assert {k: router.route(k) for k in KEYS[:50]} == placement
    live.discard(4)  # unrelated shrink: still pinned
    assert {k: router.route(k) for k in KEYS[:50]} == placement
    assert router.stats["replaced"] == 0


def test_router_replaces_only_on_own_worker_departure():
    live = {1, 2, 3}
    router = SessionRouter(lambda: sorted(live))
    placement = {k: router.route(k) for k in KEYS[:60]}
    victims = [k for k, n in placement.items() if n == 2]
    assert victims  # statistical certainty over 60 keys
    live.discard(2)
    replaced = {k: router.route(k) for k in KEYS[:60]}
    for k, n in replaced.items():
        if k in victims:
            assert n in {1, 3}  # re-placed among survivors...
        else:
            assert n == placement[k]  # ...everyone else untouched
    assert router.stats["replaced"] == len(victims)
    # the re-placement is itself sticky
    assert {k: router.route(k) for k in KEYS[:60]} == replaced


def test_router_eligible_limits_fresh_placements_not_pins():
    live = {1, 2, 3}
    router = SessionRouter(lambda: sorted(live))
    node = router.route("a", eligible=[2])
    assert node == 2  # fresh placement constrained to the eligible set
    # a live pin wins even when excluded from eligibility: stickiness first
    assert router.route("a", eligible=[1, 3]) == 2


def test_router_evict_and_end_session():
    live = {1, 2}
    router = SessionRouter(lambda: sorted(live))
    for k in KEYS[:20]:
        router.route(k)
    on_1 = router.sessions_on(1)
    assert sorted(router.evict_node(1)) == sorted(on_1)
    assert router.sessions_on(1) == []
    router.end_session(KEYS[0])
    assert router.lookup(KEYS[0]) is None


def test_router_no_live_nodes_returns_none():
    router = SessionRouter(lambda: [])
    assert router.route("x") is None
