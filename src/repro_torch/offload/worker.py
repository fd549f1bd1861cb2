"""Worker-process bootstrap (port of ``repro.offload.worker``).

The reference runs one HAM node in its own process in two launch modes:
forked children attached to a shared-memory fabric, and fresh interpreters
attaching over TCP.  Neither the shm/socket fabrics nor process workers are
ported yet (ROADMAP item 11b), so the port's spawn functions raise
:class:`NotImplementedError` naming that item; they never fall back to
thread workers.  :class:`~repro_torch.cluster.pool.ClusterPool.local` runs
thread workers over the in-process fabric.

What works already is :func:`registered_setup_modules`, the same-source
import list a worker derives from the host's registry.
"""

from __future__ import annotations

from repro_torch.core.registry import default_registry

#: what a process-worker entry point of the port says until item 11b lands
NOT_PORTED = (
    "is not ported yet: process workers and the shm/socket fabrics are "
    "ROADMAP item 11b (the port runs thread workers: ClusterPool.local)"
)


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


def spawn_shm_workers(fabric, node_ids, setup_modules=None) -> list:
    """Forked children over shared-memory rings (ROADMAP item 11b)."""
    raise NotImplementedError(f"spawn_shm_workers {NOT_PORTED}")


def spawn_socket_worker_subprocess(node_id: int, num_nodes: int, base_port: int,
                                   setup_modules=None):
    """A fresh-interpreter worker over TCP (ROADMAP item 11b)."""
    raise NotImplementedError(f"spawn_socket_worker_subprocess {NOT_PORTED}")


def spawn_shm_worker_subprocess(fabric, node_id: int, setup_modules=None):
    """A fresh-interpreter worker attached to a shm fabric (ROADMAP item
    11b: the only safe launch once a process has touched CUDA, which
    cannot survive ``fork``)."""
    raise NotImplementedError(f"spawn_shm_worker_subprocess {NOT_PORTED}")
