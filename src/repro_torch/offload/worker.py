"""Worker-process bootstrap: run one HAM node in its own process (port of
``repro.offload.worker``; a worker never imports torch unless its handler
modules do).

Two launch modes:

* :func:`spawn_shm_workers` — fork children attached to a
  :class:`~repro_torch.comm.shm.ShmFabric` (intra-node, SCIF/DMA analogue).
* ``python -m repro_torch.offload.worker '<json-spec>'`` — a *fresh interpreter*
  (different process image => the "heterogeneous binaries" case) attaching
  over TCP.  The spec names the modules that register user handlers; the
  worker imports them (static initialisation), calls ``ham.init()``, checks
  nothing about the peer — agreement is guaranteed by the deterministic key
  map, and *verified* via the digest ping.

Both modes end when the host sends ``_ham/terminate``.
"""

from __future__ import annotations

import importlib
import json
import multiprocessing
import sys

from repro_torch.core.registry import default_registry


def registered_setup_modules(registry=None, extra=()) -> list[str]:
    """Modules whose import (re-)registers the host's handler set.

    A worker must import the SAME registering modules as the host before
    ``init()``, or the two processes derive different key maps — the
    paper's same-source assumption.  This derives that module list from
    the registry itself (every pending handler's defining module), so a
    host that imported, say, ``repro_torch.cluster.pool`` (which registers
    ``_cluster/*`` at import) automatically ships it to its workers.
    ``__main__`` is dropped: script-local handlers cannot be re-imported
    by a fresh interpreter and must be registered via an importable module.
    """
    reg = registry or default_registry()
    mods = {r.fn.__module__ for r in reg.pending_records()}
    mods.update(extra)
    mods.discard("__main__")
    return sorted(m for m in mods if m)


def _worker_body(kind: str, args: dict, node_id: int, setup_modules: list[str]) -> None:
    for mod in setup_modules:
        importlib.import_module(mod)
    table = default_registry().init()
    if kind == "shm":
        from repro_torch.comm.shm import RingConfig, ShmEndpoint

        endpoint = ShmEndpoint(args["prefix"], node_id, args["num_nodes"],
                               peers=args.get("peers"),
                               config=RingConfig.from_dict(args.get("ring")))
    elif kind == "socket":
        from repro_torch.comm.socket import SocketEndpoint

        endpoint = SocketEndpoint(
            node_id, args["num_nodes"], args["base_port"], args.get("host", "127.0.0.1")
        )
    else:
        raise ValueError(f"unknown fabric kind {kind!r}")

    from repro_torch.offload.runtime import NodeRuntime

    runtime = NodeRuntime(node_id, endpoint, table)
    # queue-depth feedback to the host (node 0); a no-op unless the handler
    # set includes _cluster/stats (i.e. the host runs a cluster scheduler)
    runtime.enable_depth_report(dst=0)
    try:
        runtime.run()
    finally:
        # a handler exception or interpreter teardown must still detach the
        # endpoint: on shm fabrics a child that exits without closing keeps
        # /dev/shm mappings referenced (the segment-leak path)
        endpoint.close()


def spawn_shm_workers(fabric, node_ids, setup_modules=None) -> list:
    """Fork one child per worker node, attached to ``fabric`` (ShmFabric).

    ``setup_modules=None`` (default) derives the worker's import list from
    the host's default registry via :func:`registered_setup_modules`, so
    both sides agree on the key map by construction.

    Segment-leak contract: the *fabric* owns the ``/dev/shm`` segments and
    unlinks them from ``ShmFabric.close`` (also registered ``atexit``), so a
    child dying mid-run cannot leak them; callers must still reap the
    children (``p.join``/``terminate`` — ``ClusterPool.close`` does both).
    """
    if setup_modules is None:
        setup_modules = registered_setup_modules()
    ctx = multiprocessing.get_context("fork")
    procs = []
    for node_id in node_ids:
        p = ctx.Process(
            target=_worker_body,
            args=(
                "shm",
                _shm_args(fabric),
                node_id,
                list(setup_modules),
            ),
            daemon=True,
        )
        p.start()
        procs.append(p)
    return procs


def _shm_args(fabric) -> dict:
    """Endpoint-construction args for a worker attaching to ``fabric``.
    ``peers`` carries the live member set — an elastic fabric may have holes
    (retired ids) whose segments no longer exist."""
    return {
        "prefix": fabric.prefix,
        "num_nodes": fabric.num_nodes,
        "peers": fabric.nodes(),
        # wakeup tunables travel with the spawn spec (JSON-serialisable) so
        # forked and fresh-interpreter workers honour the fabric's RingConfig
        "ring": fabric.config.as_dict(),
    }


def reap(procs, timeout: float = 5.0) -> None:
    """Join with escalation to terminate, then kill — children never outlive
    the pool (the other half of the segment-leak fix).  Accepts
    ``multiprocessing.Process`` and ``subprocess.Popen`` handles."""
    import subprocess

    for p in procs:
        if hasattr(p, "is_alive"):  # multiprocessing.Process
            p.join(timeout)
            if p.is_alive():
                p.terminate()
                p.join(1.0)
            if p.is_alive():
                p.kill()
                p.join(1.0)
        else:  # subprocess.Popen
            try:
                p.wait(timeout)
            except subprocess.TimeoutExpired:
                p.terminate()
                try:
                    p.wait(1.0)
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.wait(1.0)


def _spawn_worker_subprocess(spec: dict):
    import os
    import subprocess

    env = dict(os.environ)
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.offload.worker", json.dumps(spec)], env=env
    )


def spawn_socket_worker_subprocess(
    node_id: int, num_nodes: int, base_port: int, setup_modules=None
):
    """Launch a worker as a *fresh* interpreter over TCP (subprocess).

    ``setup_modules=None`` derives the import list from the host's default
    registry (see :func:`registered_setup_modules`) — a fresh interpreter
    has no inherited state, so it must re-run the same static-init imports.
    """
    if setup_modules is None:
        setup_modules = registered_setup_modules()
    return _spawn_worker_subprocess({
        "kind": "socket",
        "args": {"num_nodes": num_nodes, "base_port": base_port},
        "node_id": node_id,
        "setup_modules": list(setup_modules),
    })


def spawn_shm_worker_subprocess(fabric, node_id: int, setup_modules=None):
    """Launch a worker as a *fresh* interpreter attached to a ShmFabric.

    Same wire/segment behaviour as :func:`spawn_shm_workers`, but with no
    ``os.fork`` — required once the parent has started threads that cannot
    survive forking (a process that has initialised CUDA is the canonical case).
    """
    if setup_modules is None:
        setup_modules = registered_setup_modules()
    return _spawn_worker_subprocess({
        "kind": "shm",
        "args": _shm_args(fabric),
        "node_id": node_id,
        "setup_modules": list(setup_modules),
    })


def _leave_segments_to_the_fabric(prefix: str) -> None:
    """Stop this interpreter's resource tracker from tracking the fabric's
    own segments (rings and doorbells, all named ``{prefix}_...``).  Before
    Python 3.13 ``SharedMemory`` registers every segment it *attaches* too,
    and the tracker of a fresh interpreter unlinks them all when that
    interpreter exits, killed or not: the host's live rings and doorbells
    vanish, and a respawned worker finds nothing to attach.  The fabric
    owner alone owns their lifetime (:func:`spawn_shm_workers`).  Any other
    shared memory, such as a segment a handler module creates, stays
    tracked.  A forked child shares its parent's tracker and keeps the
    default.  The reference worker does not do this (ROADMAP, reference
    behaviours the port does not mirror)."""
    from multiprocessing import resource_tracker

    register, unregister = resource_tracker.register, resource_tracker.unregister

    def _fabric_owned(name, rtype):
        return rtype == "shared_memory" and name.lstrip("/").startswith(prefix + "_")

    def _register(name, rtype):
        if not _fabric_owned(name, rtype):
            register(name, rtype)

    def _unregister(name, rtype):
        if not _fabric_owned(name, rtype):
            unregister(name, rtype)

    resource_tracker.register, resource_tracker.unregister = _register, _unregister


def main(argv: list[str]) -> int:
    spec = json.loads(argv[0])
    if spec["kind"] == "shm":
        _leave_segments_to_the_fabric(spec["args"]["prefix"])
    _worker_body(spec["kind"], spec["args"], spec["node_id"], spec["setup_modules"])
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
