"""Serving engine: continuous batching over a HAM device handler table (port
of ``repro.serve.engine``, single process).

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
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.device_table import DeviceHandlerTable
from repro_torch.models.api import resolve_device, tree_map


@dataclasses.dataclass
class Request:
    prompt: np.ndarray           # (S,) int
    max_new_tokens: int = 16
    temperature: float = 0.0     # 0 => greedy
    rid: int = -1


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
        self.payload["temp"].fill_(0.0)
        toks = []
        for _ in range(k):
            self.payload = self.dispatch(self.key_greedy, self.payload)
            toks.append(self.payload["tokens"][:, 0])
        self.steps_dispatched += k
        toks_np = torch.stack(toks).cpu().numpy()  # (k, B): one host transfer
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
