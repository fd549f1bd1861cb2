"""Model of the shm ring's double-publish torn-counter mitigation (PR 1).

CPython ``struct.pack_into``/``unpack_from`` on shared memory can tear an
8-byte counter: a reader racing a writer observes a value that was *never
stored* — typically a fabricated-high ``head`` that sends the consumer past
the published bytes into garbage.  PR 1 mitigated this by publishing every
counter twice (primary then confirm copy) and having readers re-read until
the independently loaded pair matches.

This module models one monotonic counter (``head``) as two half-words so a
torn load/store is a first-class pair of transitions, not a probabilistic
event.  The writer publishes the values ``1..publishes`` in order; a single
reader performs one load.  Safety: a load may be *stale* (monotonic
counters make stale conservative) but must never exceed the newest value
whose publication has begun — a fabricated-high counter is exactly the
frame-boundary corruption PR 1 fixed.

Layout offsets and step orders are imported from :mod:`repro_torch.comm.shm`, so
the model and the implementation share one source of truth.  With
``mitigated=False`` the reader does what the pre-PR-1 code did — one raw
load of the primary word, no confirm compare — and the checker must
rediscover the fabrication.
"""

from __future__ import annotations

from repro_torch.comm.shm import (
    COUNTER_CONFIRM_STRIDE,
    COUNTER_LOAD_ORDER,
    COUNTER_STABLE_RETRIES,
    COUNTER_STORE_ORDER,
    HEAD_CONFIRM_OFF,
    HEAD_OFF,
)

__all__ = ["RingCounterModel"]

# The model is built for the implemented layout: one u64 confirm copy
# directly after each primary word, stored primary-first, loaded
# confirm-first.  If the implementation reshapes, these trip and force the
# model to be revisited rather than silently verifying the wrong protocol.
assert HEAD_CONFIRM_OFF == HEAD_OFF + COUNTER_CONFIRM_STRIDE
assert COUNTER_STORE_ORDER == ("primary", "confirm")
assert set(COUNTER_LOAD_ORDER) == {"primary", "confirm"}

#: the implementation retries ``COUNTER_STABLE_RETRIES`` (10000) times
#: before the min() fallback; the model shrinks the bound so the fallback
#: path is reachable and verified, not just the happy path
MODEL_RETRIES = min(2, COUNTER_STABLE_RETRIES)

_DONE = -1  # reader pc sentinel


def _halves(v: int) -> tuple[int, int]:
    """(lo, hi) half-words of a counter value, stored/loaded lo-first
    (little-endian: low bytes land first)."""
    return v & 1, v >> 1


def _value(lo: int, hi: int) -> int:
    return (hi << 1) | lo


class RingCounterModel:
    """States are tuples ``(w_pc, mem, r_pc, regs, retries, accepted)``:

    * ``w_pc`` — writer micro-step counter; each publish is four half-word
      stores (primary lo, primary hi, confirm lo, confirm hi).
    * ``mem`` — ``(p_lo, p_hi, c_lo, c_hi)`` shared half-words.
    * ``r_pc``/``regs``/``retries`` — reader program counter, loaded
      half-word registers, and retry count.
    * ``accepted`` — the value the reader returned, or None.
    """

    def __init__(self, *, publishes: int = 2, mitigated: bool = True):
        # below 2 publishes no fabricated-high value is constructible and
        # the broken variant would vacuously verify
        if publishes < 2:
            raise ValueError("need >= 2 publishes to expose a torn read")
        self.publishes = publishes
        self.mitigated = mitigated
        self.name = (
            f"ring-counters({'mitigated' if mitigated else 'BROKEN'}, "
            f"publishes={publishes})"
        )
        # reader load program: half-words of each word in the
        # implementation's load order (confirm first when mitigated)
        if mitigated:
            self._loads = [
                (word, half)
                for word in COUNTER_LOAD_ORDER
                for half in ("lo", "hi")
            ]
        else:
            self._loads = [("primary", "lo"), ("primary", "hi")]

    # -- state helpers -----------------------------------------------------

    def initial_state(self):
        return (0, (0, 0, 0, 0), 0, (None, None, None, None), 0, None)

    def _max_safe(self, w_pc: int) -> int:
        """Newest value whose publication has begun.  Frame bytes are
        written before the counter stores start, so accepting this value is
        safe; anything above it points past published data."""
        return (w_pc + 3) // 4

    # -- transition relation ----------------------------------------------

    def actions(self, state):
        w_pc, mem, r_pc, regs, retries, accepted = state
        out = []

        # writer: four half-word stores per publish, order derived from
        # COUNTER_STORE_ORDER x (lo, hi)
        if w_pc < 4 * self.publishes:
            publish = w_pc // 4 + 1
            word, half = (
                COUNTER_STORE_ORDER[(w_pc % 4) // 2],
                ("lo", "hi")[w_pc % 2],
            )
            lo, hi = _halves(publish)
            val = lo if half == "lo" else hi
            slot = {"primary": 0, "confirm": 2}[word] + (half == "hi")
            new_mem = list(mem)
            new_mem[slot] = val
            out.append((
                f"writer: publish {publish}: store {word} {half}={val}",
                (w_pc + 1, tuple(new_mem), r_pc, regs, retries, accepted),
            ))

        # reader
        if r_pc != _DONE:
            if r_pc < len(self._loads):
                word, half = self._loads[r_pc]
                slot = {"primary": 0, "confirm": 2}[word] + (half == "hi")
                new_regs = list(regs)
                new_regs[slot] = mem[slot]
                out.append((
                    f"reader: load {word} {half}={mem[slot]}",
                    (w_pc, mem, r_pc + 1, tuple(new_regs), retries, accepted),
                ))
            else:
                out.append(self._decide(state))
        return out

    def _decide(self, state):
        w_pc, mem, r_pc, regs, retries, accepted = state
        p = _value(regs[0], regs[1])
        if not self.mitigated:
            return (
                f"reader: accept raw primary={p} (no confirm compare)",
                (w_pc, mem, _DONE, regs, retries, p),
            )
        c = _value(regs[2], regs[3])
        if p == c:
            return (
                f"reader: primary==confirm=={p}, accept",
                (w_pc, mem, _DONE, regs, retries, p),
            )
        if retries + 1 < MODEL_RETRIES:
            return (
                f"reader: primary={p} != confirm={c}, retry",
                (w_pc, mem, 0, (None, None, None, None), retries + 1,
                 accepted),
            )
        v = min(p, c)
        return (
            f"reader: retries exhausted, accept min({p}, {c})={v}",
            (w_pc, mem, _DONE, regs, retries + 1, v),
        )

    # -- properties --------------------------------------------------------

    def invariant(self, state):
        w_pc, _mem, _r_pc, _regs, _retries, accepted = state
        if accepted is not None and accepted > self._max_safe(w_pc):
            return (
                f"torn counter: reader accepted {accepted}, but only "
                f"{self._max_safe(w_pc)} was ever published — the consumer "
                "would read past the published bytes (PR 1)"
            )
        return None

    def deadlock(self, state):
        """No parking in this protocol: every terminal state is benign."""
