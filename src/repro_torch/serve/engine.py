"""Serving engine: continuous batching over a HAM device handler table (port
of ``repro.serve.engine``): the single-process :class:`ServingEngine` and
:class:`ClusterServingEngine`, which runs one replica per thread worker of a
:class:`~repro_torch.cluster.pool.ClusterPool` and drives them through the
HAM runtime (worker-driven decode loops or host lockstep).

All per-step behaviours — greedy decode, temperature sampling, and a
``noop`` padding step — are branches of one :class:`DeviceHandlerTable`
sharing a payload::

    payload = {cache, tokens (B,1), pos (B,), temp}

Step selection is an integer key that indexes the branch list (HAM's O(1)
key dispatch).  Slots admit new requests by writing a prefilled prompt cache
into the batch cache (continuous batching): every leaf of the cache tree,
the prompt's prefix of a KV cache and the whole lane of a recurrent state,
each along its own batch axis (``Model.cache_batch_axis``).

Differences from the reference, all forced by PyTorch:

* the reference donates the payload to each compiled dispatch; here every
  decode step writes its one new position into the cache **in place**, so a
  step never copies the multi-GB cache;
* the sampling stream is a ``torch.Generator`` the engine owns, seeded from
  ``seed`` (the reference threads a ``jax.random`` key through the payload);
  the two streams differ, so only greedy transcripts match the reference;
* ``step_many(k)`` is a loop of k dispatches whose tokens stay on the
  device and cross to the host once at the end of the block.

What the reference engine cannot serve is refused with a ``ValueError``
(serving it would be a feature the reference lacks): a prompt longer than a
windowed model's ring cache (the reference's ``dynamic_update_slice`` of
the prompt's K/V fails), a ``kv_quant`` model (its prefill cache has no
scale leaves to insert) and the ``audio``/``vlm`` families (the reference
admits tokens only).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.core.device_table import DeviceHandlerTable
from repro_torch.core.future import Future
from repro_torch.core.trace import span
from repro_torch.models.api import resolve_device, tree_map


@dataclasses.dataclass
class Request:
    prompt: np.ndarray           # (S,) int
    max_new_tokens: int = 16
    temperature: float = 0.0     # 0 => greedy
    rid: int = -1
    #: seconds of decode budget from admission (None => no deadline).  An
    #: expired request leaves the running batch at the next step, frees its
    #: slot and ends its session (docs/failure-model.md: abandoned requests)
    deadline: float | None = None


def build_serve_table(model, params, *, generator: torch.Generator):
    """Device handler table over decode-step behaviours; ``generator``
    drives the sample branch."""
    table = DeviceHandlerTable()

    def _next_from_logits(logits, payload, sample: bool):
        last = logits[:, -1, :]
        greedy = last.argmax(dim=-1)
        if sample:
            # Gumbel-max: argmax(logits / temp + g) draws from softmax(logits / temp)
            temp = payload["temp"].clamp(min=1e-4)
            u = torch.rand(last.shape, generator=generator, device=last.device)
            draw = (last.float() / temp - torch.log(-torch.log(u))).argmax(dim=-1)
            nxt = torch.where(payload["temp"] > 0, draw, greedy)
        else:
            nxt = greedy
        return nxt[:, None]

    def _decode(payload, sample: bool):
        logits, cache = model.decode_step(
            params, payload["cache"],
            {"tokens": payload["tokens"], "pos": payload["pos"]},
        )
        return {"cache": cache,
                "tokens": _next_from_logits(logits, payload, sample),
                "pos": payload["pos"] + 1, "temp": payload["temp"]}

    def decode_greedy(payload):
        return _decode(payload, sample=False)

    def decode_sample(payload):
        return _decode(payload, sample=True)

    def noop(payload):
        # bubble/straggler filler: burns a step slot without touching state
        return dict(payload)

    table.register("serve/decode_greedy", decode_greedy)
    table.register("serve/decode_sample", decode_sample)
    table.register("serve/noop", noop)
    table.seal()
    return table


def _check_fits(full, part, axis: int, t: int) -> None:
    """Raise if a prefill leaf is longer than its cache leaf on an axis
    other than the batch axis: a prompt longer than a windowed model's ring
    of min(max_len, window) positions."""
    for a, (n_full, n_part) in enumerate(zip(full.shape, part.shape)):
        if a != axis and n_part > n_full:
            raise ValueError(f"prompt of {t} tokens is longer than the cache's ring of "
                             f"{n_full} positions (a windowed model keeps "
                             f"min(max_len, window))")


def _insert(full, part, axis: int, slot: int) -> None:
    """Write a one-sequence prefill leaf into lane ``slot`` of the batch
    cache leaf, in place, at offset 0 on every other axis (the reference's
    ``dynamic_update_slice`` at ``(.., slot, 0, ..)``): a KV cache takes the
    prompt's prefix ``[:t]``, a recurrent state its whole lane."""
    src = part.select(axis, 0)
    full.select(axis, slot)[tuple(slice(0, n) for n in src.shape)].copy_(src)


class ServingEngine:
    """Continuous-batching loop on top of the dispatch table.

    ``device=None`` means the card and raises where CUDA is absent; the
    model must live on the same device.
    """

    def __init__(self, model, params, *, num_slots: int, max_len: int,
                 seed: int = 0, device=None):
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model on {model.device}, engine on {self.device}")
        if model.cfg.family in ("audio", "vlm"):
            raise ValueError(f"the serving engine admits token prompts only; "
                             f"{model.cfg.family!r} models need frames or patches")
        if model.cfg.kv_quant:
            raise ValueError("the serving engine does not take a kv_quant model: its "
                             "prefill cache holds no int8 scales to insert")
        self.model = model
        self.params = params
        self.B = num_slots
        self.max_len = max_len
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.table = build_serve_table(model, params, generator=self.generator)
        self.payload = {
            "cache": model.init_cache(num_slots, max_len),
            "tokens": torch.zeros((num_slots, 1), dtype=torch.int64, device=self.device),
            "pos": torch.zeros((num_slots,), dtype=torch.int32, device=self.device),
            "temp": torch.zeros((), dtype=torch.float32, device=self.device),
        }
        self.dispatch = self.table.build()
        self.key_greedy = self.table.key_of("serve/decode_greedy")
        self.key_sample = self.table.key_of("serve/decode_sample")
        self.key_noop = self.table.key_of("serve/noop")
        # slot bookkeeping (host side)
        self.slot_req: list[Request | None] = [None] * num_slots
        self.slot_remaining = np.zeros(num_slots, np.int64)
        self.outputs: dict[int, list[int]] = {}
        self.steps_dispatched = 0

    # -- slot admission ----------------------------------------------------------

    def admit(self, req: Request, slot: int) -> None:
        """Fused admission: prefill, batch-cache insert, slot token/pos
        writes and the first token's argmax, with one host transfer (the
        first token)."""
        prompt = np.asarray(req.prompt, np.int64)
        if not 1 <= prompt.shape[0] <= self.max_len:
            raise ValueError(
                f"prompt length {prompt.shape[0]} outside [1, max_len={self.max_len}]"
            )
        tokens = torch.from_numpy(prompt[None, :]).to(self.device)
        logits, pcache = self.model.prefill(self.params, {"tokens": tokens})
        t, axes = prompt.shape[0], self.model.cache_batch_axis
        if isinstance(axes, int):
            axes = tree_map(lambda _, axis=axes: axis, pcache)
        tree_map(lambda full, part, axis: _check_fits(full, part, axis, t),
                 self.payload["cache"], pcache, axes)
        tree_map(lambda full, part, axis: _insert(full, part, axis, slot),
                 self.payload["cache"], pcache, axes)
        first = logits[0, -1, :].argmax()
        self.payload["tokens"][slot, 0] = first
        self.payload["pos"][slot] = t
        self.slot_req[slot] = req
        self.slot_remaining[slot] = req.max_new_tokens - 1
        self.outputs[req.rid] = [int(first)]

    def free_slots(self) -> list[int]:
        return [i for i, r in enumerate(self.slot_req) if r is None]

    def evict(self, rid: int) -> bool:
        """Free the slot decoding ``rid`` without emitting (cancel/deadline
        departure): its stale cache lane is overwritten by the next
        admission."""
        for slot, r in enumerate(self.slot_req):
            if r is not None and r.rid == rid:
                self.slot_req[slot] = None
                self.slot_remaining[slot] = 0
                return True
        return False

    # -- stepping ------------------------------------------------------------------

    def _emit(self, toks: np.ndarray, active: list[int]) -> list[tuple[int, int]]:
        """Record one step's tokens (B,) for the still-running active slots."""
        emitted: list[tuple[int, int]] = []
        for slot in active:
            req = self.slot_req[slot]
            if req is None:
                continue  # budget reached earlier in this block
            tok = int(toks[slot])
            emitted.append((req.rid, tok))
            self.outputs[req.rid].append(tok)
            self.slot_remaining[slot] -= 1
            if self.slot_remaining[slot] <= 0:
                self.slot_req[slot] = None
        return emitted

    def step(self, key: int | None = None) -> list[tuple[int, int]]:
        """One batched decode step through the dispatch table.

        Returns the ``(rid, token)`` pairs emitted this step (empty for a
        noop step).  With every slot idle and no explicit ``key`` the call
        returns at once without dispatching.
        """
        active = [i for i, r in enumerate(self.slot_req) if r is not None]
        if key is None and not active:
            return []
        if key is None:
            if any(r is not None and r.temperature > 0 for r in self.slot_req):
                key = self.key_sample
            else:
                key = self.key_greedy
        temps = max((r.temperature for r in self.slot_req if r is not None),
                    default=0.0)
        self.payload["temp"].fill_(temps)
        self.payload = self.dispatch(key, self.payload)
        self.steps_dispatched += 1
        if key == self.key_noop:
            return []
        return self._emit(self.payload["tokens"][:, 0].cpu().numpy(), active)

    def step_many(self, k: int) -> list[tuple[int, int]]:
        """Up to ``k`` greedy decode steps as one block: k dispatches whose
        tokens are stacked on the device and cross to the host once.

        Semantics match ``k`` sequential :meth:`step` calls: slot lanes are
        independent, so a slot whose budget ends mid-block has its surplus
        lane tokens dropped host-side.  Sampling falls back to single steps,
        as in the reference.
        """
        if k <= 1:
            return self.step()
        active = [i for i, r in enumerate(self.slot_req) if r is not None]
        if not active:
            return []
        if any(self.slot_req[s].temperature > 0 for s in active):
            out: list[tuple[int, int]] = []
            for _ in range(k):
                out.extend(self.step())
                if all(r is None for r in self.slot_req):
                    break
            return out
        with span("engine.dispatch", k, cpu=True):
            self.payload["temp"].fill_(0.0)
            toks = []
            for _ in range(k):
                self.payload = self.dispatch(self.key_greedy, self.payload)
                toks.append(self.payload["tokens"][:, 0])
            stacked = torch.stack(toks)
        self.steps_dispatched += k
        toks_np = stacked.cpu().numpy()  # (k, B): one host transfer
        emitted: list[tuple[int, int]] = []
        for i in range(k):
            emitted.extend(self._emit(toks_np[i], active))
        return emitted

    def run(self, requests: list[Request]) -> dict[int, list[int]]:
        """Serve a request list to completion with continuous batching."""
        for i, r in enumerate(requests):
            if r.rid < 0:
                r.rid = i
        pending = list(requests)
        while pending or any(r is not None for r in self.slot_req):
            for slot in self.free_slots():
                if not pending:
                    break
                self.admit(pending.pop(0), slot)
            self.step()
        return self.outputs


# --------------------------------------------------------------------------
# cluster serving: continuous batching driven through the worker pool
# --------------------------------------------------------------------------

# the control handlers and their replica map live in repro_torch.serve.handlers
# (a torch-free module, cheap for fresh-interpreter workers to re-import);
# re-exported here for callers that predate the split
from repro_torch.serve.handlers import (  # noqa: E402,F401
    _NODE_ENGINES,
    _NODE_LOOPS,
    _STREAM_BLOCK_SINKS,
    _STREAM_SINKS,
    MAX_PROMPT,
    pad_prompt,
    register_serve_handlers,
)


class ClusterServingEngine:
    """Continuous batching sharded across a worker pool.

    One :class:`ServingEngine` replica per pool worker (thread workers —
    the replicas share the process, its card and one copy of ``params``;
    each owns its cache).  Two drive modes:

    **Worker-driven** (default, the production path — docs/serving.md):
    each replica gets a :class:`~repro_torch.serve.stream.WorkerDecodeLoop` that
    self-steps its continuous batch; the host's per-request involvement is
    ONE ``_serve/admit_stream`` slot-lease call (FLAG_STATIC), after which
    tokens stream back as fused ``_serve/stream`` oneways.  The host loop
    reduces to admission control — per-worker slot accounting plus a
    bounded admission queue that sheds with :class:`OffloadError` on
    overflow — and completion bookkeeping through the
    :class:`~repro_torch.cluster.sessions.SessionRouter`.  Host RPCs per emitted
    token drop from ~1 (lockstep) to ``1/max_new_tokens``.

    **Lockstep** (``worker_driven=False``): the host drives every replica
    with one pipelined ``_serve/step`` call in flight per active worker —
    kept behind the flag as the benchmark's comparison leg; both modes
    produce token-identical output on the same prompts/seed (greedy decode
    is deterministic and slot-isolated).

    Request routing goes through the scheduler's :class:`SessionRouter`:
    each request is a session keyed ``serve/<rid>``, placed once by
    rendezvous hash over the workers *with a free slot* at admission time,
    then pinned — every subsequent call for that request lands on the
    worker holding its KV cache, and an unrelated pool resize cannot move
    it (the stickiness contract in ``repro_torch.cluster.sessions``).  The
    engine's slot accounting stays its own (the router knows placement,
    not capacity).

    **Serving elasticity** (ROADMAP): engine replicas follow pool
    membership, not construction — ``on_join``/``on_restart`` build a
    replica for the newcomer, ``on_leave``/``on_death`` retire it (a
    drained removal drops the replica only after the node's in-flight
    steps finish), so serving survives ``pool.add_node()`` /
    ``pool.remove_node()`` mid-run and newly added capacity takes
    admissions immediately.

    **Session recovery**: the host is the system of record for every
    admitted request (prompt + every emitted token), which makes a
    worker's KV state *reconstructible*: when a worker dies mid-decode,
    :meth:`run` re-admits its requests on a survivor with the
    concatenated ``prompt + tokens-so-far`` as the new prefill — the
    session re-places (its old pin died), decode continues exactly where
    it stopped, and no emitted token is lost.  A completed request ends
    its session through ``Scheduler.end_session`` (which also releases
    any directory-tracked buffers bound to it).
    """

    def __init__(self, model, params, *, num_workers: int = 2,
                 slots_per_worker: int = 2, max_len: int, seed: int = 0,
                 registry=None, worker_driven: bool = True,
                 admission_limit: int | None = None, decode_block: int = 16,
                 device=None):
        import threading

        from repro_torch.cluster.pool import ClusterPool, register_cluster_handlers
        from repro_torch.cluster.scheduler import Scheduler
        from repro_torch.core.registry import HandlerRegistry
        from repro_torch.offload.runtime import register_internal_handlers

        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model on {model.device}, engine on {self.device}")
        if registry is None:
            registry = HandlerRegistry()
            register_internal_handlers(registry)
            register_cluster_handlers(registry)
            register_serve_handlers(registry)
            registry.init()
        self.registry = registry
        self.slots_per_worker = slots_per_worker
        self.worker_driven = bool(worker_driven)
        #: bounded admission queue (worker-driven mode): submit_request
        #: sheds with OffloadError past this depth; None => unbounded
        self.admission_limit = admission_limit
        #: decode steps each worker loop fuses per iteration (step_many)
        self.decode_block = max(1, int(decode_block))
        self._model, self._params = model, params
        self._max_len, self._seed = max_len, seed
        self.pool = ClusterPool.local(num_workers, registry=registry)
        self.sched = Scheduler(self.pool, policy="least_outstanding",
                               max_inflight=slots_per_worker + 2)
        self._engine_keys: dict[int, int] = {}  # node -> id(runtime)
        # -- worker-driven host state (all guarded by _wd) ------------------
        self._wd = threading.Condition()
        self._pending: list[Request] = []       # admission queue (FIFO)
        self._transcripts: dict[int, list[int]] = {}
        self._events: dict[int, dict] = {}      # rid -> timing/seq record
        self._gen: dict[int, int] = {}          # rid -> stream generation
        self._budget: dict[int, int] = {}
        self._temp: dict[int, float] = {}
        self._prompt0: dict[int, Any] = {}
        self._expires: dict[int, float | None] = {}   # absolute monotonic
        self._placed: dict[int, int] = {}       # rid -> node decoding it
        self._admitting: dict[int, int] = {}    # rid -> node, admit in flight
        self._active: dict[int, int] = {}       # node -> occupied slots
        self._queued: dict[int, int] = {}       # node -> unconfirmed admits
        self._done: dict[int, int] = {}         # rid -> final stream status
        self._cancel_req: dict[int, int] = {}   # rid -> requested status
        self._errors: dict[int, Exception] = {}
        self._end_q: list[int] = []             # sessions to end (pump-side)
        self._next_rid = 0
        self.shed = 0                           # admission-overflow count
        self._pump: threading.Thread | None = None
        self._pump_stop = False
        if self.worker_driven:
            _STREAM_SINKS[id(self.pool.host)] = self._on_stream
            _STREAM_BLOCK_SINKS[id(self.pool.host)] = self._on_stream_block
        for node in self.pool.worker_nodes:
            self._add_replica(node)
        # serving elasticity: replicas track membership from here on
        self.pool.on_join(self._add_replica)
        self.pool.on_restart(self._add_replica)
        self.pool.on_death(self._on_death)
        self.pool.on_leave(self._on_leave)

    # -- replica lifecycle (elasticity contract in the class docs) ---------

    def _add_replica(self, node: int) -> None:
        rt = self.pool.domain._inproc.get(node)
        if rt is None:
            # the reference builds no replica here and returns; the port
            # never leaves a worker silently without one
            raise NotImplementedError(
                f"node {node} has no in-process runtime: serving replicas run "
                "on thread workers only (ClusterPool.local), as in the reference"
            )
        self._drop_replica(node)  # a restarted node gets a fresh engine
        eng = ServingEngine(
            self._model, self._params, num_slots=self.slots_per_worker,
            max_len=self._max_len, seed=self._seed + node, device=self.device,
        )
        _NODE_ENGINES[id(rt)] = eng
        if self.worker_driven:
            from repro_torch.serve.stream import WorkerDecodeLoop

            _NODE_LOOPS[id(rt)] = WorkerDecodeLoop(
                rt, eng, host_node=self.pool.domain.host_node,
                registry=self.registry, name=f"-{node}",
                block=self.decode_block,
            )
        self._engine_keys[node] = id(rt)
        with self._wd:
            self._wd.notify_all()  # fresh capacity for the admission pump

    def _drop_replica(self, node: int) -> None:
        key = self._engine_keys.pop(node, None)
        if key is not None:
            loop = _NODE_LOOPS.pop(key, None)
            if loop is not None:
                loop.stop(join=False)
            _NODE_ENGINES.pop(key, None)

    def _on_death(self, node: int) -> None:
        self._drop_replica(node)
        if self.worker_driven:
            self._recover_node(node)

    def _on_leave(self, node: int):
        # retire the replica only AFTER the scheduler's drain waiter let the
        # node's in-flight steps finish (waiters run in subscription order;
        # the scheduler subscribed first)
        def waiter(timeout: float | None = None) -> None:
            self._drop_replica(node)
            if self.worker_driven:
                # drained removal mid-decode: its requests repin elsewhere
                self._recover_node(node)

        return waiter

    def serving_nodes(self) -> list[int]:
        """Live workers that currently hold an engine replica."""
        live = set(self.sched.live_nodes())
        return sorted(n for n in self._engine_keys if n in live)

    # -- worker-driven mode: admission control + stream bookkeeping ---------

    def _on_stream(self, node: int, rid: int, gen: int, seq: int,
                   token: int, status: int, free_slots: int) -> None:
        """Token sink — runs on the host event-loop thread per fused
        segment; must stay cheap and never block.  Session teardown is
        deferred to the pump thread via ``_end_q``."""
        import time

        now = time.monotonic()
        with self._wd:
            # ground-truth occupancy from the worker's own slot count
            # (queued-but-unapplied admits are still in _queued)
            self._active[node] = self.slots_per_worker - int(free_slots)
            self._apply_stream_locked(node, rid, gen, seq, token, status, now)
            self._wd.notify_all()

    def _on_stream_block(self, node: int, rid: int, gen: int, seq0: int,
                         tokens, status: int, free_slots: int) -> None:
        """Block sink: a whole fused decode block's tokens for one request
        under ONE lock acquisition — ``status`` applies to the last token,
        the earlier ones are implicitly STREAM_TOKEN."""
        import time

        from repro_torch.core.flags import STREAM_TOKEN

        now = time.monotonic()
        with self._wd:
            self._active[node] = self.slots_per_worker - int(free_slots)
            last = len(tokens) - 1
            for i, tok in enumerate(tokens):
                st = status if i == last else STREAM_TOKEN
                self._apply_stream_locked(node, rid, gen, seq0 + i,
                                          int(tok), st, now)
            self._wd.notify_all()

    def _apply_stream_locked(self, node: int, rid: int, gen: int, seq: int,
                             token: int, status: int, now: float) -> None:
        from repro_torch.core.flags import STREAM_DONE, STREAM_TOKEN

        if self._gen.get(rid) != gen or rid in self._done:
            return  # stale generation (pre-recovery straggler) or late
        # placement ground truth: the node actually streaming wins over
        # the admit-time pick (a session can re-place mid-admit if the
        # picked worker died between route and send)
        self._placed[rid] = node
        ev = self._events.setdefault(rid, {})
        if status in (STREAM_TOKEN, STREAM_DONE) and token >= 0:
            t = self._transcripts.setdefault(rid, [])
            if len(t) < self._budget.get(rid, 1 << 30):
                t.append(int(token))
                ev.setdefault("t_first", now)
                ev.setdefault("token_ts", []).append(now)
            # fused-oneway ordering contract: seq counts emissions
            # within this generation — any gap/reorder trips this flag
            expected = len(t) - 1 - ev.get("seq_base", 0)
            if seq != expected:
                ev["seq_ok"] = False
        if status == STREAM_DONE or (
            status == STREAM_TOKEN
            and len(self._transcripts.get(rid, ()))
            >= self._budget.get(rid, 1 << 30)
        ):
            self._finalize_locked(rid, STREAM_DONE)
        elif status not in (STREAM_TOKEN, STREAM_DONE):
            self._finalize_locked(rid, status)

    def _finalize_locked(self, rid: int, status: int) -> None:
        self._done[rid] = status
        self._placed.pop(rid, None)
        self._admitting.pop(rid, None)
        self._cancel_req.pop(rid, None)
        self._end_q.append(rid)

    def _recover_node(self, node: int) -> None:
        """A serving node left mid-decode (death or drained removal): its
        replica's KV is gone, but the host holds prompt + every emitted
        token — bump each of its requests' stream generation (stragglers
        from the old loop are dropped by gen mismatch) and re-queue them as
        continuation admits; their sessions repin on a survivor."""
        with self._wd:
            self._active[node] = 0
            self._queued[node] = 0
            for rid in [r for r, n in self._placed.items() if n == node]:
                self._placed.pop(rid, None)
                self._requeue_locked(rid)
            for rid in [r for r, n in self._admitting.items() if n == node]:
                self._admitting.pop(rid, None)
                self._requeue_locked(rid)
            self._wd.notify_all()

    def _requeue_locked(self, rid: int) -> None:
        import time

        from repro_torch.core.flags import STREAM_DONE, STREAM_EXPIRED

        if rid in self._done:
            return
        now = time.monotonic()
        if rid in self._cancel_req:
            self._finalize_locked(rid, self._cancel_req[rid])
            return
        done_toks = self._transcripts.get(rid, [])
        remaining = self._budget[rid] - len(done_toks)
        if remaining <= 0:
            self._finalize_locked(rid, STREAM_DONE)
            return
        expires = self._expires.get(rid)
        if expires is not None and now >= expires:
            self._finalize_locked(rid, STREAM_EXPIRED)
            return
        self._gen[rid] += 1
        ev = self._events.setdefault(rid, {})
        ev["repins"] = ev.get("repins", 0) + 1
        ev["seq_base"] = len(done_toks)
        # continuation admit: prefill of prompt + tokens-so-far picks up
        # decode exactly where the departed worker stopped
        self._pending.insert(0, Request(
            prompt=np.concatenate(
                [np.asarray(self._prompt0[rid], np.int32),
                 np.asarray(done_toks, np.int32)]
            ),
            max_new_tokens=remaining,
            temperature=self._temp[rid],
            rid=rid,
        ))

    def _ensure_pump(self) -> None:
        import threading

        with self._wd:
            if self._pump is not None or self._pump_stop:
                return
            self._pump = threading.Thread(
                target=self._pump_loop, name="ham-serve-admit", daemon=True
            )
            self._pump.start()

    def _pump_loop(self) -> None:
        """Admission pump: places each pending request's session once
        (rendezvous hash over workers with a free slot), leases the slot
        with ONE ``_serve/admit_stream`` submit through the router, and
        retires completed sessions.  This thread is the only caller of
        ``sched.submit``/``end_session`` in worker-driven mode — the event
        loop's sink never blocks on scheduler locks."""
        import time

        from repro_torch.core.flags import STREAM_EXPIRED

        while True:
            with self._wd:
                while not self._pump_stop and not self._pending \
                        and not self._end_q:
                    self._wd.wait(0.05)
                if self._pump_stop:
                    return
                ended, self._end_q = self._end_q, []
                batch = self._collect_admits_locked()
            for rid in ended:
                self.sched.end_session(f"serve/{rid}")
            for req, node, gen in batch:
                self._send_admit(req, node, gen)
            if not batch and not ended:
                time.sleep(0.002)  # pending but nowhere admissible yet
                # host-side deadline sweep for queue-stuck requests
                with self._wd:
                    now = time.monotonic()
                    for i in range(len(self._pending) - 1, -1, -1):
                        rid = self._pending[i].rid
                        exp = self._expires.get(rid)
                        if exp is not None and now >= exp:
                            del self._pending[i]
                            self._finalize_locked(rid, STREAM_EXPIRED)
                            self._wd.notify_all()

    def _collect_admits_locked(self) -> list:
        """Match pending requests to workers with lease capacity (the
        lockstep admission scan, minus the per-step traffic): session pins
        win; fresh placements go rendezvous-hash over workers with a free
        slot.  A request whose pinned worker is full must not block the
        queue behind it."""
        batch = []
        nodes = self.serving_nodes()
        if not nodes:
            return batch
        while self._pending:
            free = [
                n for n in nodes
                if self._active.get(n, 0) + self._queued.get(n, 0)
                < self.slots_per_worker
            ]
            if not free:
                break
            pick = None
            for idx, req in enumerate(self._pending):
                node = self.sched.sessions.route(
                    f"serve/{req.rid}", eligible=free
                )
                if node is not None and node in free:
                    pick = (idx, node)
                    break
            if pick is None:
                break  # every pending request waits on a full pin
            idx, node = pick
            req = self._pending.pop(idx)
            self._queued[node] = self._queued.get(node, 0) + 1
            self._admitting[req.rid] = node
            batch.append((req, node, self._gen[req.rid]))
        return batch

    def _send_admit(self, req: Request, node: int, gen: int) -> None:
        import time

        from repro_torch.core.closure import f2f

        prompt = np.asarray(req.prompt, np.int32)
        expires = self._expires.get(req.rid)
        deadline_s = 0.0
        if expires is not None:
            deadline_s = max(expires - time.monotonic(), 1e-3)
        try:
            fut = self.sched.submit(
                f2f("_serve/admit_stream", pad_prompt(prompt),
                    int(prompt.shape[0]), int(req.rid), int(gen),
                    int(req.max_new_tokens), float(req.temperature),
                    float(deadline_s), registry=self.registry),
                session=f"serve/{req.rid}",
            )
        except Exception as e:  # noqa: BLE001 — no live workers / backpressure
            self._admit_failed(req.rid, node, e)
            return
        fut.add_done_callback(
            lambda f, rid=req.rid, n=node, g=gen: self._on_admit_done(
                f, rid, n, g)
        )

    def _on_admit_done(self, fut, rid: int, node: int, gen: int) -> None:
        try:
            fut.get(0)
        except Exception as e:  # noqa: BLE001 — classified below
            self._admit_failed(rid, node, e)
            return
        with self._wd:
            self._queued[node] = max(0, self._queued.get(node, 0) - 1)
            if self._admitting.pop(rid, None) is not None \
                    and rid not in self._done and self._gen.get(rid) == gen:
                self._placed[rid] = node
            self._wd.notify_all()

    def _admit_failed(self, rid: int, node: int, exc: Exception) -> None:
        """Lease call failed: a dead/draining worker re-queues the request
        (its session re-places); a failure on a healthy worker is a real
        error and fails the request diagnosably."""
        with self._wd:
            self._queued[node] = max(0, self._queued.get(node, 0) - 1)
            if self._admitting.pop(rid, None) is None or rid in self._done:
                self._wd.notify_all()
                return
            if self.pool.is_alive(node) and node in self._engine_keys:
                self._errors[rid] = exc
                self._finalize_locked(rid, -1)
            else:
                self._requeue_locked(rid)
            self._wd.notify_all()

    # -- worker-driven public API -------------------------------------------

    def submit_request(self, req: Request, *, shed: bool = True) -> int:
        """Admit one request into the serving system (worker-driven mode).

        Non-blocking: returns the request id immediately; tokens accumulate
        in the host transcript as the worker streams them.  With ``shed=``
        True (the open-loop default), raises :class:`OffloadError` when the
        admission queue is at ``admission_limit`` — shed-on-overflow is the
        back-pressure contract of the open-loop harness.
        """
        import time

        from repro_torch.core.errors import OffloadError

        if not self.worker_driven:
            raise OffloadError(
                "submit_request requires worker_driven=True "
                "(lockstep mode only supports run())"
            )
        self._ensure_pump()
        with self._wd:
            if req.rid < 0:
                req.rid = self._next_rid
            rid = req.rid
            self._next_rid = max(self._next_rid, rid + 1)
            if rid in self._budget and rid not in self._done:
                raise OffloadError(f"request {rid} is already in flight")
            if shed and self.admission_limit is not None \
                    and len(self._pending) >= self.admission_limit:
                self.shed += 1
                raise OffloadError(
                    f"admission queue full ({self.admission_limit}); "
                    f"request {rid} shed"
                )
            prompt = np.asarray(req.prompt, np.int32)
            if prompt.shape[0] + req.max_new_tokens > MAX_PROMPT:
                raise OffloadError(
                    f"prompt+budget {prompt.shape[0] + req.max_new_tokens} "
                    f"exceeds the serve wire bound MAX_PROMPT={MAX_PROMPT}"
                )
            now = time.monotonic()
            # rid reuse after completion (back-to-back run() calls): reset
            self._done.pop(rid, None)
            self._errors.pop(rid, None)
            self._transcripts[rid] = []
            self._events[rid] = {}
            self._gen[rid] = self._gen.get(rid, -1) + 1
            self._budget[rid] = int(req.max_new_tokens)
            self._temp[rid] = float(req.temperature)
            self._prompt0[rid] = prompt
            self._expires[rid] = (
                now + req.deadline if req.deadline is not None else None
            )
            self._pending.append(req)
            self._wd.notify_all()
            return rid

    def cancel(self, rid: int, *, status: int | None = None) -> bool:
        """Cancel a request: it leaves the running batch at the worker's
        next step, frees its slot, and its session ends.  Returns False
        when the request already finished."""
        from repro_torch.core.closure import f2f
        from repro_torch.core.errors import OffloadError
        from repro_torch.core.flags import STREAM_CANCELLED

        status = STREAM_CANCELLED if status is None else int(status)
        with self._wd:
            if rid not in self._budget:
                raise OffloadError(f"unknown request {rid}")
            if rid in self._done:
                return False
            for i, q in enumerate(self._pending):
                if q.rid == rid:  # still queued host-side: shed locally
                    del self._pending[i]
                    self._finalize_locked(rid, status)
                    self._wd.notify_all()
                    return True
            self._cancel_req[rid] = status
            gen = self._gen[rid]
        try:
            self.sched.oneway(
                f2f("_serve/cancel", int(rid), int(gen), int(status),
                    registry=self.registry),
                session=f"serve/{rid}",
            )
        except Exception:  # noqa: BLE001 — worker died: recovery finalizes
            pass
        return True

    def wait(self, rids=None, timeout: float | None = 300.0) -> None:
        """Block until every request in ``rids`` (default: all submitted)
        reached a terminal state; raises the first recorded per-request
        error, TimeoutError past ``timeout``, or OffloadError when the
        pool can no longer serve the remainder."""
        import time

        from repro_torch.core.errors import OffloadError

        deadline = (
            None if timeout is None else time.monotonic() + timeout
        )
        with self._wd:
            target = set(self._budget) if rids is None else set(rids)
            while not target <= self._done.keys():
                waiting = target - self._done.keys()
                if not self.serving_nodes() and not self.pool.worker_nodes:
                    raise OffloadError(
                        f"no live serving workers remain for {len(waiting)} "
                        "unfinished requests"
                    )
                remaining = (
                    None if deadline is None
                    else deadline - time.monotonic()
                )
                if remaining is not None and remaining <= 0:
                    raise TimeoutError(
                        f"cluster serve exceeded {timeout}s with "
                        f"{len(waiting)} requests unfinished"
                    )
                self._wd.wait(
                    0.1 if remaining is None else min(0.1, remaining)
                )
            for rid in sorted(target & self._errors.keys()):
                raise self._errors[rid]

    def _run_worker_driven(self, requests: list[Request],
                           timeout: float) -> dict[int, list[int]]:
        rids = [self.submit_request(r, shed=False) for r in requests]
        self.wait(rids, timeout=timeout)
        with self._wd:
            out = {rid: list(self._transcripts.get(rid, ())) for rid in rids}
        for rid in rids:  # idempotent with the pump's session teardown
            self.sched.end_session(f"serve/{rid}")
        return out

    def run(self, requests: list[Request],
            timeout: float = 300.0) -> dict[int, list[int]]:
        """Serve ``requests`` to completion; survives pool resizes and
        worker deaths mid-run (class docs).  ``timeout`` bounds the whole
        drive.  Worker-driven by default; ``worker_driven=False`` at
        construction selects the lockstep drive loop."""
        for i, r in enumerate(requests):
            if r.rid < 0:
                r.rid = i
        if self.worker_driven:
            return self._run_worker_driven(requests, timeout)
        return self._run_lockstep(requests, timeout)

    def _run_lockstep(self, requests: list[Request],
                      timeout: float = 300.0) -> dict[int, list[int]]:
        """Host-lockstep drive loop: one pipelined ``_serve/step`` call in
        flight per active worker (the benchmark's comparison leg)."""
        import queue as _queue
        import time

        from repro_torch.core.closure import f2f
        from repro_torch.core.errors import OffloadError

        for i, r in enumerate(requests):
            if r.rid < 0:
                r.rid = i
        pending = list(requests)
        outputs: dict[int, list[int]] = {}
        budget = {r.rid: r.max_new_tokens for r in requests}
        temp = {r.rid: r.temperature for r in requests}
        prompt0 = {r.rid: np.asarray(r.prompt, np.int32) for r in requests}
        placed: dict[int, int] = {}  # rid -> node currently decoding it
        # per-node occupancy: `active` is ground truth as of the last reply
        # from that node; `queued` counts admits submitted but unconfirmed
        active: dict[int, int] = {}
        queued: dict[int, int] = {}
        stepping: dict[int, bool] = {}
        inflight: dict[Future, tuple[str, int, int | None]] = {}
        # one persistent completion queue for the whole drive: every
        # submitted future pushes itself here exactly once when done
        done_q: _queue.SimpleQueue = _queue.SimpleQueue()
        deadline = time.monotonic() + timeout
        reg = self.registry

        def track(fut: Future, kind: str, node: int,
                  rid: int | None = None) -> None:
            inflight[fut] = (kind, node, rid)
            fut.add_done_callback(done_q.put)

        def requeue(rid: int) -> None:
            """Continuation admit: prefill of prompt + tokens-so-far picks
            up decode exactly where the dead worker stopped."""
            done_toks = outputs.get(rid, [])
            remaining = budget[rid] - len(done_toks)
            if remaining <= 0:
                return  # finished just before the crash
            pending.append(Request(
                prompt=np.concatenate(
                    [prompt0[rid], np.asarray(done_toks, np.int32)]
                ),
                max_new_tokens=remaining,
                temperature=temp[rid],
                rid=rid,
            ))

        def recover_node(node: int) -> None:
            """A serving node died: its replica's KV is gone, but the host
            holds prompt + every emitted token — re-queue its requests as
            continuation admits on a survivor."""
            active[node] = 0
            queued[node] = 0
            stepping[node] = False
            for rid in [r for r, n in placed.items() if n == node]:
                placed.pop(rid, None)
                requeue(rid)

        while pending or inflight or any(active.values()):
            nodes = self.serving_nodes()
            # death sweep: a victim with NO call in flight produces no
            # failed future (its last step reply may have been processed
            # before the monitor marked it dead) — reap by state, not only
            # by exception, or its requests would be orphaned silently
            busy = set(placed.values()) \
                | {n for n, a in active.items() if a} \
                | {n for n, q in queued.items() if q}
            for node in busy - set(nodes):
                if not (self.pool.is_alive(node)
                        and node in self._engine_keys):
                    recover_node(node)
            # admission: place each request's session once (rendezvous hash
            # over workers with a free slot), then submit THROUGH the router
            # so the admit sticks to the placement.  A request whose live
            # pin is full waits for a slot THERE (KV must not split across
            # workers) but must not block admission of the requests behind
            # it — scan past it to the first admissible request instead
            while pending and nodes:
                free = [
                    n for n in nodes
                    if active.get(n, 0) + queued.get(n, 0)
                    < self.slots_per_worker
                ]
                if not free:
                    break
                admit_idx = None
                node = None
                for idx, req in enumerate(pending):
                    placed_node = self.sched.sessions.route(
                        f"serve/{req.rid}", eligible=free
                    )
                    if placed_node is not None and placed_node in free:
                        admit_idx, node = idx, placed_node
                        break
                if admit_idx is None:
                    break  # every pending request waits on a full pin
                req = pending.pop(admit_idx)
                queued[node] = queued.get(node, 0) + 1
                track(self.sched.submit(
                    f2f("_serve/admit", np.asarray(req.prompt, np.int32),
                        int(req.rid), int(req.max_new_tokens),
                        float(req.temperature), registry=reg),
                    session=f"serve/{req.rid}",
                ), "admit", node, req.rid)
            for node in nodes:
                if (active.get(node, 0) or queued.get(node, 0)) \
                        and not stepping.get(node, False):
                    stepping[node] = True
                    track(self.sched.submit(
                        f2f("_serve/step", registry=reg), node=node,
                    ), "step", node)
            if not inflight:
                if pending and not self.serving_nodes():
                    raise OffloadError(
                        "no live serving workers remain for "
                        f"{len(pending)} pending requests"
                    )
                if not pending:
                    break
                time.sleep(0.02)  # pinned worker full: wait for a slot
                continue
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise TimeoutError(
                    f"cluster serve exceeded {timeout}s with "
                    f"{len(inflight)} calls in flight"
                )
            try:
                done = done_q.get(timeout=remaining)
            except _queue.Empty:
                raise TimeoutError(
                    f"cluster serve exceeded {timeout}s with "
                    f"{len(inflight)} calls in flight"
                ) from None
            kind, node, rid = inflight.pop(done)
            try:
                result = done.get(0)
            except Exception:
                # a dead/removed worker fails its in-flight calls; anything
                # else (slot bug, handler error) must surface.  Liveness is
                # checked at the pool (marked dead before futures fail), not
                # via serving_nodes(): the replica-drop callback may still
                # be a few callbacks behind the future rejection.
                if self.pool.is_alive(node) and node in self._engine_keys:
                    raise
                recover_node(node)
                if kind == "admit" and rid is not None and rid not in placed:
                    # the admit itself died in flight: its request is in no
                    # placed map — re-queue it explicitly
                    requeue(rid)
                continue
            if kind == "admit":
                rid, first = result
                queued[node] = queued.get(node, 0) - 1
                active[node] = active.get(node, 0) + 1
                placed[rid] = node
                # a recovery re-admit continues an existing transcript
                outputs.setdefault(rid, []).append(first)
                if len(outputs[rid]) >= budget[rid]:
                    placed.pop(rid, None)
            else:
                stepping[node] = False
                emitted, free = result
                active[node] = self.slots_per_worker - free
                for rid, tok in emitted:
                    # the slot-remaining accounting emits one trailing token
                    # for a single-token (re-)admission — cap the transcript
                    # at its budget so a continuation cannot over-emit
                    if len(outputs[rid]) < budget[rid]:
                        outputs[rid].append(tok)
                    if len(outputs[rid]) >= budget[rid]:
                        placed.pop(rid, None)
        for r in requests:  # sessions end with their requests
            self.sched.end_session(f"serve/{r.rid}")
        return outputs

    def close(self) -> None:
        with self._wd:
            self._pump_stop = True
            self._wd.notify_all()
        if self._pump is not None:
            self._pump.join(timeout=5.0)
            self._pump = None
        _STREAM_SINKS.pop(id(self.pool.host), None)
        _STREAM_BLOCK_SINKS.pop(id(self.pool.host), None)
        for key in list(self._engine_keys.values()):
            loop = _NODE_LOOPS.pop(key, None)
            if loop is not None:
                loop.stop()
            _NODE_ENGINES.pop(key, None)
        self._engine_keys.clear()
        self.pool.close()
