"""Cluster-serving control handlers, importable by worker processes (port
of ``repro.serve.handlers``: the same stable names, specs and wire bounds;
the module stays free of torch, as the reference's stays free of JAX).

These live apart from ``repro_torch.serve.engine`` because the *registering*
module must be cheap to import everywhere: a worker derives its import
list from the modules that define the host's handlers
(:func:`repro_torch.offload.worker.registered_setup_modules`), and if the
handlers lived in ``engine.py`` every fresh-interpreter worker would pull
torch and the model stack at spawn just to re-register a few control functions.
Here the module-level registration (static initialisation, paper §4.3)
costs a numpy import; the engine itself is only imported by nodes that
actually host a serving replica.

Two handler sets register here:

* the **lockstep** pair ``_serve/admit`` / ``_serve/step`` — the host
  drives every decode step (kept behind ``worker_driven=False``);
* the **worker-driven** trio (docs/serving.md): ``_serve/admit_stream``
  (host->worker slot lease, FLAG_STATIC — the prompt rides padded to
  ``MAX_PROMPT`` so the payload is plan-packed with fixed extents),
  ``_serve/cancel`` (host->worker oneway), and ``_serve/stream``
  (worker->host fused token oneways).  The stream handlers are all-scalar
  static specs, so each token message plan-packs into a tiny fixed-size
  segment — the FLAG_FUSED fast path end to end.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.errors import RegistrySealedError
from repro_torch.core.migratable import ArraySpec, ScalarSpec

#: wire bound on a (padded) admission prompt: prompt + replayed tokens of a
#: continuation re-admit must fit.  A fixed extent is what makes the admit
#: payload FLAG_STATIC (plan-packed, no per-message descriptors).
MAX_PROMPT = 512

#: engines owned by pool workers, keyed by the identity of the worker's
#: NodeRuntime — handlers resolve "their" engine via current_node().  (One
#: entry per live runtime; ClusterServingEngine.close() removes its own.)
_NODE_ENGINES: dict[int, object] = {}

#: worker decode loops (repro_torch.serve.stream.WorkerDecodeLoop), same keying
_NODE_LOOPS: dict[int, object] = {}

#: host-side token sinks, keyed by id(host runtime): the `_serve/stream`
#: handler forwards each token message to its engine's bookkeeping callback
_STREAM_SINKS: dict[int, object] = {}

#: host-side block sinks (`_serve/stream_block`), same keying: one message
#: carries a whole fused decode block's tokens for one request
_STREAM_BLOCK_SINKS: dict[int, object] = {}

#: wire bound on tokens per `_serve/stream_block` message (fixed extent =
#: plan-packed static payload; a decode block larger than this is chunked)
STREAM_BLOCK_MAX = 32

_I8 = ScalarSpec("i8")
_F8 = ScalarSpec("f8")

#: padded prompt, prompt_len, rid, gen, max_new_tokens, temperature, deadline_s
ADMIT_STREAM_SPECS = (ArraySpec((MAX_PROMPT,), "int32"),
                      _I8, _I8, _I8, _I8, _F8, _F8)
#: node, rid, gen, seq, token, status, free_slots
STREAM_SPECS = (_I8, _I8, _I8, _I8, _I8, _I8, _I8)
#: node, rid, gen, seq0, count, tokens (padded), status, free_slots
STREAM_BLOCK_SPECS = (_I8, _I8, _I8, _I8, _I8,
                      ArraySpec((STREAM_BLOCK_MAX,), "int32"), _I8, _I8)
#: rid, gen, status
CANCEL_SPECS = (_I8, _I8, _I8)


def pad_prompt(prompt: np.ndarray) -> np.ndarray:
    """Zero-pad a prompt to the fixed ``MAX_PROMPT`` wire extent."""
    prompt = np.asarray(prompt, np.int32)
    if prompt.shape[0] > MAX_PROMPT:
        from repro_torch.core.errors import OffloadError

        raise OffloadError(
            f"prompt of {prompt.shape[0]} tokens exceeds the serve wire "
            f"bound MAX_PROMPT={MAX_PROMPT}"
        )
    out = np.zeros(MAX_PROMPT, np.int32)
    out[: prompt.shape[0]] = prompt
    return out


# -- lockstep handlers ------------------------------------------------------


def _h_serve_admit(prompt, rid, max_new_tokens, temperature):
    """Admit one request into this node's engine (prefill runs HERE, on the
    worker, overlapping other workers' decode steps).  Returns the first
    generated token."""
    from repro_torch.core.errors import OffloadError
    from repro_torch.offload.runtime import current_node
    from repro_torch.serve.engine import Request

    eng = _NODE_ENGINES.get(id(current_node()))
    if eng is None:
        # the replica was retired (node mid-removal) or never built (a
        # non-local worker mode) — fail diagnosably; the driver only admits
        # through serving_nodes(), so reaching this is a routing bug
        raise OffloadError("no serving-engine replica on this worker")
    free = eng.free_slots()
    if not free:
        # a session re-placed here by a death mid-admission (the router's
        # eligible= restriction applies to the engine's placement, not to a
        # re-placement inside Scheduler.submit) — fail diagnosably rather
        # than IndexError; the driver surfaces it as RemoteExecutionError
        raise OffloadError("no free serving slot on this worker")
    slot = free[0]
    req = Request(
        prompt=np.asarray(prompt, np.int32),
        max_new_tokens=int(max_new_tokens),
        temperature=float(temperature),
        rid=int(rid),
    )
    eng.admit(req, slot)
    return [int(rid), int(eng.outputs[req.rid][0])]


def _h_serve_step():
    """One decode step of this node's engine; returns the emitted
    ``[rid, token]`` pairs plus the engine's free-slot count (ground truth
    for the driver's admission accounting)."""
    from repro_torch.offload.runtime import current_node

    eng = _NODE_ENGINES[id(current_node())]
    emitted = eng.step()
    return [[int(r), int(t)] for r, t in emitted], len(eng.free_slots())


# -- worker-driven handlers (docs/serving.md) -------------------------------


def _h_serve_admit_stream(prompt, prompt_len, rid, gen, max_new_tokens,
                          temperature, deadline_s):
    """Slot lease: queue one request into this worker's decode loop.  The
    ONLY host round trip a request needs — prefill, every decode step, and
    token emission happen on the worker from here on.  Returns the
    ``[rid, gen]`` lease ack (tokens travel separately via _serve/stream)."""
    from repro_torch.core.errors import OffloadError
    from repro_torch.offload.runtime import current_node

    loop = _NODE_LOOPS.get(id(current_node()))
    if loop is None:
        raise OffloadError("no worker decode loop on this node")
    loop.enqueue_admit(
        np.asarray(prompt[: int(prompt_len)], np.int32), int(rid), int(gen),
        int(max_new_tokens), float(temperature), float(deadline_s),
    )
    return [int(rid), int(gen)]


def _h_serve_cancel(rid, gen, status):
    """Cancel oneway: the request leaves the running batch at the loop's
    next step; the loop acks with a `_serve/stream` end-of-stream marker
    (unconditionally — even for a request it never saw)."""
    from repro_torch.offload.runtime import current_node

    loop = _NODE_LOOPS.get(id(current_node()))
    if loop is not None:
        loop.cancel(int(rid), int(gen), int(status))


def _h_serve_stream(node, rid, gen, seq, token, status, free_slots):
    """Host-side token sink: one decoded token (or end-of-stream marker)
    from a worker's decode loop, riding a fused oneway.  Dropped silently
    when no sink is registered (engine torn down mid-stream)."""
    from repro_torch.offload.runtime import current_node

    sink = _STREAM_SINKS.get(id(current_node()))
    if sink is not None:
        sink(int(node), int(rid), int(gen), int(seq), int(token),
             int(status), int(free_slots))


def _h_serve_stream_block(node, rid, gen, seq0, count, tokens, status,
                          free_slots):
    """Host-side block sink: one fused decode block's tokens for a single
    request in ONE plan-packed segment — per-message dispatch cost is paid
    once per block instead of once per token.  ``seq0`` is the sequence
    number of the first token; ``status`` applies to the LAST token (the
    earlier ones are implicitly STREAM_TOKEN)."""
    from repro_torch.offload.runtime import current_node

    sink = _STREAM_BLOCK_SINKS.get(id(current_node()))
    if sink is not None:
        sink(int(node), int(rid), int(gen), int(seq0),
             np.asarray(tokens[: int(count)], np.int64), int(status),
             int(free_slots))


def register_serve_handlers(registry=None) -> None:
    """Register the cluster-serving handlers.  Safe to call repeatedly;
    silently skipped on an already-sealed registry (as with the cluster /
    dataplane sets — then callers must have registered before ``init()``)."""
    from repro_torch.core.registry import default_registry

    # every handler mutates node-local serving state (admission writes a
    # prompt cache into the batch; step/stream advance it) — never
    # replica-servable
    reg = registry or default_registry()
    for name, fn, specs in (
        ("_serve/admit", _h_serve_admit, None),
        ("_serve/step", _h_serve_step, None),
        ("_serve/admit_stream", _h_serve_admit_stream, ADMIT_STREAM_SPECS),
        ("_serve/cancel", _h_serve_cancel, CANCEL_SPECS),
        ("_serve/stream", _h_serve_stream, STREAM_SPECS),
        ("_serve/stream_block", _h_serve_stream_block, STREAM_BLOCK_SPECS),
    ):
        try:
            reg.register(fn, name=name, arg_specs=specs, read_only=False)
        except RegistrySealedError:
            return


# module import = static initialisation: a worker that imports this module
# (because the host's registry includes _serve/*) re-derives the same keys
register_serve_handlers()
