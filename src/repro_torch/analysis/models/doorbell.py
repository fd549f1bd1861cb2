"""Model of the doorbell arm/park/wake protocol (PR 7).

The shm receiver parks on a futex word instead of burning CPU; the protocol
has two known lost-wakeup windows that PR 7 closed:

* *publish-before-arm*: a frame published before ``waiters`` is set gets no
  wake — closed by the MANDATORY ring re-poll between arm and park.
* *publish-after-repoll*: a frame published after the re-poll bumps ``seq``
  — closed by FUTEX_WAIT's compare-on-entry against the pre-poll snapshot.

This model explores every interleaving of N producers (each: publish,
non-atomic two-step seq bump, read waiters, conditional wake) against one
consumer driven by :data:`repro_torch.comm.doorbell.CONSUMER_PARK_PROTOCOL` —
the step list is built from the implementation's tuple, so reordering the
implementation (e.g. snapshotting ``seq`` after the re-poll) reshapes the
model and the checker finds the stranded park.

FUTEX_WAIT has no timeout here: a park that nothing will ever wake is a
deadlock state, and the checker flags it when published frames are pending
(liveness-as-safety).  A park with nothing pending is benign — in the real
system ``park_timeout`` bounds it and termination arrives as a frame.  The
model's guarantee is interleaving-level: it assumes each half-word access
is sequentially consistent, which CPython shared memory on x86/ARM-with-
GIL-handoff approximates; see docs/static-analysis.md for the caveat.
"""

from __future__ import annotations

from repro_torch.comm.doorbell import (
    CONSUMER_PARK_PROTOCOL,
    PRODUCER_RING_PROTOCOL,
    SEQ_OFF,
    WAITERS_OFF,
    Doorbell,
)

__all__ = ["DoorbellModel"]

# Layout: two distinct u32 words in one segment, futex on the seq word.
assert SEQ_OFF != WAITERS_OFF
assert max(SEQ_OFF, WAITERS_OFF) + 4 <= Doorbell.NBYTES

# The step VOCABULARY is fixed; the step ORDER is taken from the tuples so
# an implementation reorder is model-checked rather than assumed away.
assert set(PRODUCER_RING_PROTOCOL) == {
    "publish", "bump_seq", "read_waiters", "wake_if_armed",
}
assert PRODUCER_RING_PROTOCOL[0] == "publish"
assert set(CONSUMER_PARK_PROTOCOL) == {
    "arm", "read_seq", "repoll", "wait_if_unchanged",
}
assert CONSUMER_PARK_PROTOCOL[0] == "arm"
assert CONSUMER_PARK_PROTOCOL[-1] == "wait_if_unchanged"

# the non-atomic seq bump is two micro-steps (Python has no atomic RMW on
# shared memory) — concurrent producers can interleave and collapse bumps
_PRODUCER_MICRO = {
    "publish": ("publish",),
    "bump_seq": ("bump_read", "bump_write"),
    "read_waiters": ("read_waiters",),
    "wake_if_armed": ("wake",),
}

_PARKED = "parked"
_TOP = "top"
_DONE = "done"


class DoorbellModel:
    """States are ``(seq, waiters, pending, producers, consumer)``:

    * ``seq``/``waiters`` — the two futex-segment words.
    * ``pending`` — published-but-unconsumed frame count (the rings).
    * ``producers`` — per-producer ``(items_left, pc, reg)``; ``pc`` indexes
      the micro-step list, ``reg`` holds the bump's read value.
    * ``consumer`` — ``(phase, reg)``; phase is ``"top"``, an index into
      the park-step list, ``"parked"``, or ``"done"``; ``reg`` is the seq
      snapshot FUTEX_WAIT compares against.
    """

    def __init__(self, *, producers: int = 2, items: int = 1,
                 repoll: bool = True, seq_check: bool = True):
        self.n_producers = producers
        self.items = items
        self.repoll = repoll
        self.seq_check = seq_check
        broken = [] if repoll else ["no-repoll"]
        if not seq_check:
            broken.append("no-seq-check")
        self.name = (
            f"doorbell({'BROKEN ' + '+'.join(broken) if broken else 'mitigated'}, "
            f"producers={producers}, items={items})"
        )
        self._psteps = [
            micro for step in PRODUCER_RING_PROTOCOL
            for micro in _PRODUCER_MICRO[step]
        ]
        self._csteps = [
            s for s in CONSUMER_PARK_PROTOCOL
            if repoll or s != "repoll"
        ]

    # -- state helpers -----------------------------------------------------

    def initial_state(self):
        producers = tuple((self.items, 0, 0) for _ in range(self.n_producers))
        return (0, 0, 0, producers, (_TOP, 0))

    @staticmethod
    def _producer_done(p) -> bool:
        items_left, pc, _reg = p
        return items_left == 0 and pc == 0

    # -- transition relation ----------------------------------------------

    def actions(self, state):
        seq, waiters, pending, producers, consumer = state
        out = []
        for i, p in enumerate(producers):
            if not self._producer_done(p):
                out.append(self._producer_step(state, i))
        out.extend(self._consumer_steps(state))
        return [a for a in out if a is not None]

    def _with_producer(self, producers, i, p):
        return producers[:i] + (p,) + producers[i + 1 :]

    def _finish_item(self, p):
        items_left, _pc, _reg = p
        return (items_left - 1, 0, 0)

    def _producer_step(self, state, i):
        seq, waiters, pending, producers, consumer = state
        items_left, pc, reg = producers[i]
        step = self._psteps[pc]
        who = f"producer {i}"
        if step == "publish":
            nxt = self._with_producer(producers, i, (items_left, pc + 1, reg))
            return (f"{who}: publish frame (pending={pending + 1})",
                    (seq, waiters, pending + 1, nxt, consumer))
        if step == "bump_read":
            nxt = self._with_producer(producers, i, (items_left, pc + 1, seq))
            return (f"{who}: bump reads seq={seq}",
                    (seq, waiters, pending, nxt, consumer))
        if step == "bump_write":
            nxt = self._with_producer(producers, i, (items_left, pc + 1, 0))
            return (f"{who}: bump writes seq={reg + 1}",
                    (reg + 1, waiters, pending, nxt, consumer))
        if step == "read_waiters":
            if waiters == 0:
                nxt = self._with_producer(producers, i, self._finish_item(
                    (items_left, pc, reg)))
                return (f"{who}: waiters==0, skip wake",
                        (seq, waiters, pending, nxt, consumer))
            nxt = self._with_producer(producers, i, (items_left, pc + 1, reg))
            return (f"{who}: waiters==1, will wake",
                    (seq, waiters, pending, nxt, consumer))
        # "wake": FUTEX_WAKE unparks whoever is parked AT SYSCALL TIME
        nxt = self._with_producer(producers, i, self._finish_item(
            (items_left, pc, reg)))
        phase, creg = consumer
        if phase == _PARKED:
            # woken consumer resumes the armed loop: re-snapshot, re-poll
            return (f"{who}: FUTEX_WAKE unparks consumer",
                    (seq, waiters, pending, nxt, (1, creg)))
        return (f"{who}: FUTEX_WAKE finds nobody parked",
                (seq, waiters, pending, nxt, consumer))

    def _consumer_steps(self, state):
        seq, waiters, pending, producers, consumer = state
        phase, reg = consumer
        if phase in (_PARKED, _DONE):
            return []
        if phase == _TOP:
            if pending:
                return [(f"consumer: poll finds {pending} frame(s), consume",
                         (seq, 0, 0, producers, (_TOP, 0)))]
            if all(self._producer_done(p) for p in producers):
                return [("consumer: all producers done, exit",
                         (seq, waiters, pending, producers, (_DONE, 0)))]
            # spin budget exhausted: enter the park sequence
            assert self._csteps[0] == "arm"
            return [("consumer: arm (waiters=1)",
                     (seq, 1, pending, producers, (1, reg)))]
        step = self._csteps[phase]
        if step == "read_seq":
            return [(f"consumer: snapshot seq={seq}",
                     (seq, waiters, pending, producers, (phase + 1, seq)))]
        if step == "repoll":
            if pending:
                return [(f"consumer: re-poll finds {pending} frame(s), "
                         "consume and disarm",
                         (seq, 0, 0, producers, (_TOP, 0)))]
            return [("consumer: re-poll finds nothing",
                     (seq, waiters, pending, producers, (phase + 1, reg)))]
        # "wait_if_unchanged"
        if self.seq_check and seq != reg:
            return [(f"consumer: FUTEX_WAIT sees seq={seq} != expected "
                     f"{reg}, EAGAIN",
                     (seq, waiters, pending, producers, (1, reg)))]
        return [(f"consumer: FUTEX_WAIT parks (seq={seq})",
                 (seq, waiters, pending, producers, (_PARKED, reg)))]

    # -- properties --------------------------------------------------------

    def invariant(self, state):
        _seq, _waiters, pending, producers, consumer = state
        if consumer[0] == _DONE and pending:
            return f"consumer exited with {pending} frame(s) pending"
        return None

    def deadlock(self, state):
        _seq, _waiters, pending, producers, consumer = state
        if consumer[0] == _PARKED and pending:
            return (
                f"lost wakeup: consumer parked forever with {pending} "
                "published frame(s) pending and all producers finished "
                "(PR 7)"
            )
        # parked with nothing pending is benign: park_timeout bounds it in
        # the real system, and termination arrives as a frame
        return None
