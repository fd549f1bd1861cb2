"""Worker-resident decode loop: self-stepping continuous batching.

The worker-driven half of cluster serving (docs/serving.md).  The host's
role shrinks to *admission*: one ``_serve/admit_stream`` call leases a slot
and hands over the prompt; from then on this loop steps the worker's
:class:`~repro_torch.serve.engine.ServingEngine` replica **without any host
involvement** — requests join and leave the running batch at block
boundaries, and tokens travel back as oneways.  Each loop iteration runs
one *fused decode block* (``engine.step_many``: ``block`` dispatches of
the device handler table whose tokens cross to the host once), then ships each request's block of tokens as ONE
``_serve/stream_block`` segment (single-token messages and end-of-stream
acks ride ``_serve/stream``).  All segments produced by one iteration are
packed into a single ``FLAG_FUSED`` frame: one header, one transport
publication, one host dispatch pass per block — the fused-egress
economics of the RPC fast path applied to token streaming.

The loop parks on its doorbell (a condition variable) whenever the batch is
empty and nothing is queued — an idle replica costs no CPU (the engine's
``step()`` early-out is the in-batch half of the same economy: a fully
idle batch never dispatches the padded noop step).

Delivery/ordering contract (asserted by the stream tests):

* per-request ordering — all stream calls for a request are emitted by one
  thread and ride per-link FIFO frames, so ``seq`` arrives strictly
  ascending within a ``(rid, gen)`` generation;
* at-most-once per generation — the host increments ``gen`` before
  re-admitting a request elsewhere (death recovery), so stragglers from a
  dead worker's loop carry a stale ``gen`` and are dropped on arrival;
* cancel/expiry acks are unconditional — a cancel for a request this loop
  has never seen (e.g. the admit died in flight) still acks, so the host
  never waits on a tombstone.

This module is torch-free at import time (the engine object is injected);
only nodes that actually host a replica pay for torch.  Port of
``repro.serve.stream``.
"""

from __future__ import annotations

import threading
import time
from collections import deque

import numpy as np

from repro_torch.core.flags import (
    STREAM_CANCELLED,
    STREAM_DONE,
    STREAM_TOKEN,
)

__all__ = ["WorkerDecodeLoop"]

#: (rid, gen) pairs already cancelled — an admit that loses the race with
#: its own cancel is dropped instead of decoding as a zombie
_TOMBSTONE_CAP = 256


class WorkerDecodeLoop:
    """One self-stepping decode thread bound to (runtime, engine replica).

    The admit/cancel entry points are called from the worker's event-loop
    thread (handler context) and only enqueue + ring the doorbell; all
    engine mutation happens on the loop thread, so the replica's payload is
    single-threaded by construction.
    """

    def __init__(self, runtime, engine, *, host_node: int = 0,
                 registry=None, name: str = "", block: int = 16):
        self._rt = runtime
        self._eng = engine
        self._host = int(host_node)
        self._registry = registry
        #: decode steps fused per loop iteration (engine.step_many): the
        #: per-dispatch overhead is paid once per block, and one fused
        #: frame carries the whole block's tokens.  Admission, cancel and
        #: deadline checks run between blocks, so their latency is bounded
        #: by block * step_time (microscopic next to the TTFT SLO).
        self._block = max(1, int(block))
        self._cv = threading.Condition()
        #: queued admissions: (prompt, rid, gen, max_new, temp, deadline_s)
        self._admits: deque = deque()
        #: cancel requests: (rid, gen, status)
        self._cancels: list[tuple[int, int, int]] = []
        self._tombstones: deque = deque(maxlen=_TOMBSTONE_CAP)
        #: rid -> {gen, seq, remaining, expires} for requests in the batch
        self._live: dict[int, dict] = {}
        self._stop = False
        self.stats = {"steps": 0, "tokens": 0, "frames": 0, "parks": 0,
                      "expired": 0, "cancelled": 0}
        self._thread = threading.Thread(
            target=self._run, name=f"ham-decode-loop{name}", daemon=True
        )
        self._thread.start()

    # -- handler-side entry points (worker event-loop thread) --------------

    def enqueue_admit(self, prompt: np.ndarray, rid: int, gen: int,
                      max_new_tokens: int, temperature: float,
                      deadline_s: float) -> None:
        with self._cv:
            if self._stop:
                from repro_torch.core.errors import OffloadError

                raise OffloadError("decode loop is stopped on this worker")
            self._admits.append((prompt, rid, gen, max_new_tokens,
                                 temperature, deadline_s))
            self._cv.notify()

    def cancel(self, rid: int, gen: int, status: int) -> None:
        with self._cv:
            self._cancels.append((rid, gen, status))
            self._cv.notify()

    def stop(self, join: bool = True) -> None:
        with self._cv:
            self._stop = True
            self._cv.notify()
        if join and self._thread is not threading.current_thread():
            self._thread.join(timeout=5.0)

    # -- loop internals (decode thread only) --------------------------------

    def _idle(self) -> bool:
        return (not self._admits and not self._cancels
                and all(r is None for r in self._eng.slot_req))

    def _stream_call(self, f2f, rid: int, gen: int, seq: int, token: int,
                     status: int):
        return f2f(
            "_serve/stream", int(self._rt.node_id), int(rid), int(gen),
            int(seq), int(token), int(status),
            len(self._eng.free_slots()), registry=self._registry,
        )

    def _stream_block_call(self, f2f, rid: int, gen: int, seq0: int,
                           toks: list, status: int):
        from repro_torch.serve.handlers import STREAM_BLOCK_MAX

        buf = np.zeros(STREAM_BLOCK_MAX, np.int32)
        buf[: len(toks)] = toks
        return f2f(
            "_serve/stream_block", int(self._rt.node_id), int(rid),
            int(gen), int(seq0), len(toks), buf, int(status),
            len(self._eng.free_slots()), registry=self._registry,
        )

    def _finish(self, f2f, rid: int, status: int, calls: list) -> None:
        """A request leaves the running batch without emitting: free its
        slot now (the next step simply doesn't include it) and ack the
        departure downstream."""
        live = self._live.pop(rid)
        self._eng.evict(rid)
        self._tombstones.append((rid, live["gen"]))
        calls.append(self._stream_call(f2f, rid, live["gen"], live["seq"],
                                       -1, status))

    def _run(self) -> None:
        from repro_torch.core.closure import f2f

        eng = self._eng
        while True:
            with self._cv:
                while not self._stop and self._idle():
                    self.stats["parks"] += 1
                    self._cv.wait()
                if self._stop:
                    return
                cancels, self._cancels = self._cancels, []
                admits = []
                free = len(eng.free_slots())
                while self._admits and len(admits) < free:
                    admits.append(self._admits.popleft())
            calls: list = []
            now = time.monotonic()
            # 1. cancels and expiries leave the batch BEFORE this step
            for rid, gen, status in cancels:
                live = self._live.get(rid)
                if live is not None and live["gen"] == gen:
                    self.stats["cancelled"] += 1
                    self._finish(f2f, rid, status, calls)
                else:
                    # never seen (admit still in flight or already gone):
                    # tombstone the generation and ack unconditionally so
                    # the host-side cancel cannot hang
                    self._tombstones.append((rid, gen))
                    calls.append(self._stream_call(f2f, rid, gen, 0, -1,
                                                   status))
            for rid in [r for r, lv in self._live.items()
                        if lv["expires"] is not None
                        and now >= lv["expires"]]:
                from repro_torch.core.flags import STREAM_EXPIRED

                self.stats["expired"] += 1
                self._finish(f2f, rid, STREAM_EXPIRED, calls)
            # 2. admissions into freed slots (prefill runs HERE, on the
            # worker, overlapping other replicas' decode steps)
            for i, (prompt, rid, gen, max_new, temp,
                    deadline_s) in enumerate(admits):
                if (rid, gen) in self._tombstones:
                    calls.append(self._stream_call(f2f, rid, gen, 0, -1,
                                                   STREAM_CANCELLED))
                    continue
                from repro_torch.serve.engine import Request

                free_now = eng.free_slots()
                if not free_now:  # slots re-counted: defer the rest
                    with self._cv:
                        self._admits.extendleft(reversed(admits[i:]))
                    break
                slot = free_now[0]
                eng.admit(Request(prompt=prompt, max_new_tokens=max_new,
                                  temperature=temp, rid=rid), slot)
                first = int(eng.outputs[rid][0])
                live = {
                    "gen": gen, "seq": 1, "remaining": max_new - 1,
                    "expires": now + deadline_s if deadline_s > 0 else None,
                }
                if max_new <= 1:
                    # single-token lease: the prefill's argmax IS the whole
                    # request — free the slot without a decode step
                    eng.evict(rid)
                    self._tombstones.append((rid, gen))
                    status = STREAM_DONE
                else:
                    self._live[rid] = live
                    status = STREAM_TOKEN
                self.stats["tokens"] += 1
                calls.append(self._stream_call(f2f, rid, gen, 0, first,
                                               status))
            # 3. one fused block of batched decode steps ([] when empty):
            # per-dispatch overhead amortised over the whole block
            emitted = eng.step_many(self._block)
            if emitted:
                self.stats["steps"] += 1
            # group each request's tokens (emitted is step-major, so the
            # per-request order is already ascending) and ship ONE
            # _serve/stream_block segment per request per block
            by_rid: dict[int, list[int]] = {}
            for rid, tok in emitted:
                by_rid.setdefault(rid, []).append(int(tok))
            from repro_torch.serve.handlers import STREAM_BLOCK_MAX

            for rid, toks in by_rid.items():
                live = self._live.get(rid)
                if live is None:
                    continue  # evicted mid-iteration
                live["remaining"] -= len(toks)
                done = live["remaining"] <= 0
                self.stats["tokens"] += len(toks)
                for i in range(0, len(toks), STREAM_BLOCK_MAX):
                    chunk = toks[i : i + STREAM_BLOCK_MAX]
                    last = i + len(chunk) >= len(toks)
                    status = STREAM_DONE if (done and last) else STREAM_TOKEN
                    calls.append(self._stream_block_call(
                        f2f, rid, live["gen"], live["seq"], chunk, status))
                    live["seq"] += len(chunk)
                if done:
                    self._live.pop(rid, None)
                    self._tombstones.append((rid, live["gen"]))
            if calls:
                self._flush(calls)

    def _flush(self, calls: list) -> None:
        """Ship this iteration's stream calls as fused oneways: msg_id 0
        segments in FLAG_FUSED frames (one frame per FUSE_MAX_SEGMENTS)."""
        from repro_torch.offload.runtime import FUSE_MAX_SEGMENTS

        try:
            if len(calls) == 1:
                self._rt.send_oneway(self._host, calls[0])
            else:
                for i in range(0, len(calls), FUSE_MAX_SEGMENTS):
                    self._rt._send_fused_request(
                        self._host,
                        [(fn, 0) for fn in calls[i : i + FUSE_MAX_SEGMENTS]],
                    )
            self.stats["frames"] += 1
        except Exception:  # noqa: BLE001 — transport died under the loop
            # (worker killed mid-send): the host transcript re-derives the
            # tokens on a survivor; stop arrives via the replica teardown
            time.sleep(0.001)
