"""Production mesh factory (port of ``repro.launch.mesh``).

Functions, not module constants: importing this module touches no
process-group state.  A mesh needs a process group of the mesh's size:

* on a real run, the caller's (``torch.distributed.init_process_group``
  with an address, a world size and a rank; on one card, one rank);
* for the dry-run, :func:`fake_world`'s: the ``fake`` backend, whose
  collectives move nothing, over a world of the production mesh's size in
  one process (the counterpart of the reference's
  ``--xla_force_host_platform_device_count``).  It is process-global, so a
  dry-run runs in a fresh interpreter.

``device=None`` is ``cuda``; the CPU (gloo or fake groups) is used only
when asked for.
"""

from __future__ import annotations

PRODUCTION = {
    False: ((16, 16), ("data", "model")),
    True: ((2, 16, 16), ("pod", "data", "model")),
}


def make_mesh(shape, axes, device=None):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the first
    ``prod(shape)`` ranks of the current process group."""
    import math

    import torch
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.models.api import resolve_device

    dev = resolve_device(device)   # None -> cuda, raising where there is none
    ranks = torch.arange(math.prod(shape)).reshape(tuple(shape))
    return DeviceMesh(dev.type, ranks, mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device=None):
    shape, axes = PRODUCTION[multi_pod]
    return make_mesh(shape, axes, device=device)


def single_rank_world(device=None) -> None:
    """A process group of one rank over an in-memory store (NCCL on the
    card, gloo on the CPU): the 1 x 1 mesh a single card runs sharded
    code on.  Does nothing if a group exists."""
    import torch.distributed as dist

    if dist.is_initialized():
        return
    backend = "nccl" if device is None or str(device).startswith("cuda") else "gloo"
    dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)


def fake_world(world_size: int) -> None:
    """The dry-run's process group: ``world_size`` fake ranks in this
    process (this process is rank 0)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)
