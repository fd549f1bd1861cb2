"""modelcheck — explicit-state exhaustive-interleaving checker.

Usage::

    python -m repro_torch.analysis.modelcheck [--quick] [--model NAME]

Explores EVERY interleaving of small step-function models of the two
hairiest shared-memory protocols in the runtime, with torn 8-byte
loads/stores modeled as first-class (two half-word) transitions:

* :mod:`repro_torch.analysis.models.ring_counters` — the shm ring's double-publish
  torn-counter mitigation (PR 1).
* :mod:`repro_torch.analysis.models.doorbell` — the seq/waiters arm-park-wake
  protocol (PR 7).

For each protocol the CLI checks BOTH directions, so a green run proves the
checker has teeth, not just green lights:

* the *mitigated* model (the protocol as implemented, constants imported
  from the implementation modules) must verify exhaustively, and
* every *broken* variant (a mitigation toggled off) must rediscover its
  historical bug as a concrete counterexample trace.

Exit status 0 only if all expectations hold.

Model interface
---------------

A model is an object with:

* ``name`` — display name,
* ``initial_state()`` — hashable state,
* ``actions(state)`` — iterable of ``(label, next_state)``; empty = final,
* ``invariant(state)`` — error string or None,
* ``deadlock(state)`` — error string or None, asked only when ``actions``
  is empty (liveness-as-safety: a stranded state is a lost wakeup).
"""

from __future__ import annotations

import dataclasses
import sys
from collections import deque

__all__ = ["ExploreResult", "explore", "main"]


@dataclasses.dataclass
class ExploreResult:
    ok: bool
    states: int
    violation: str | None = None
    trace: list[str] | None = None

    def describe(self) -> str:
        if self.ok:
            return f"verified ({self.states} states)"
        lines = [f"VIOLATION after {self.states} states: {self.violation}"]
        if self.trace:
            lines.append("shortest counterexample:")
            lines.extend(f"  {i + 1:2d}. {step}"
                         for i, step in enumerate(self.trace))
        return "\n".join(lines)


def explore(model, max_states: int = 2_000_000) -> ExploreResult:
    """BFS over the model's state graph; BFS order makes the first
    counterexample a shortest one."""
    init = model.initial_state()
    seen = {init}
    parent: dict = {init: None}  # state -> (prev_state, label)
    queue = deque([init])
    checked = 0

    def trace_to(state) -> list[str]:
        steps: list[str] = []
        while parent[state] is not None:
            state, label = parent[state]
            steps.append(label)
        steps.reverse()
        return steps

    while queue:
        state = queue.popleft()
        checked += 1
        err = model.invariant(state)
        if err is not None:
            return ExploreResult(False, checked, err, trace_to(state))
        actions = list(model.actions(state))
        if not actions:
            err = model.deadlock(state)
            if err is not None:
                return ExploreResult(False, checked, err, trace_to(state))
            continue
        for label, nxt in actions:
            if nxt not in seen:
                if len(seen) >= max_states:
                    raise RuntimeError(
                        f"state-space bound exceeded ({max_states}); "
                        "tighten the model"
                    )
                seen.add(nxt)
                parent[nxt] = (state, label)
                queue.append(nxt)
    return ExploreResult(True, checked)


def _suite(quick: bool):
    """(description, model, expect_ok) triples for the CLI gate."""
    from repro_torch.analysis.models import doorbell, ring_counters

    publishes = 2
    producers, items = (1, 1) if quick else (2, 1)
    return [
        (
            "ring-counters mitigated (double-publish + confirm compare)",
            ring_counters.RingCounterModel(publishes=publishes,
                                           mitigated=True),
            True,
        ),
        (
            "ring-counters BROKEN (single-word read, PR 1 torn counter)",
            ring_counters.RingCounterModel(publishes=publishes,
                                           mitigated=False),
            False,
        ),
        (
            "doorbell mitigated (arm -> re-poll -> seq-checked park)",
            doorbell.DoorbellModel(producers=producers, items=items),
            True,
        ),
        (
            "doorbell BROKEN no re-poll (publish-before-arm lost wakeup)",
            doorbell.DoorbellModel(producers=producers, items=items,
                                   repoll=False),
            False,
        ),
        (
            "doorbell BROKEN no seq check (publish-after-repoll lost wakeup)",
            doorbell.DoorbellModel(producers=producers, items=items,
                                   seq_check=False),
            False,
        ),
    ]


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    quick = "--quick" in argv
    argv = [a for a in argv if a != "--quick"]
    only = None
    if "--model" in argv:
        i = argv.index("--model")
        if i + 1 >= len(argv):
            print("error: --model needs a name", file=sys.stderr)
            return 2
        only = argv[i + 1]
        del argv[i : i + 2]
    if argv:
        print(f"error: unknown arguments {argv}", file=sys.stderr)
        return 2

    failures = 0
    for desc, model, expect_ok in _suite(quick):
        if only is not None and only not in desc:
            continue
        result = explore(model)
        matched = result.ok == expect_ok
        status = "PASS" if matched else "FAIL"
        print(f"[{status}] {desc}")
        if result.ok:
            print(f"       {result.describe()}")
        else:
            for line in result.describe().splitlines():
                print(f"       {line}")
        if not matched:
            failures += 1
            if expect_ok:
                print("       expected exhaustive verification, found a "
                      "violation", file=sys.stderr)
            else:
                print("       expected the seeded bug to be found — the "
                      "checker has lost its teeth", file=sys.stderr)
    if failures:
        print(f"modelcheck: {failures} expectation(s) failed",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
