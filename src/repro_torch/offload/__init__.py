"""HAM-Offload: the offloading framework built on the HAM core (paper §2)."""

from repro_torch.core.future import as_completed, gather
from repro_torch.offload.api import OffloadDomain, deref, offloaded
from repro_torch.offload.buffer import BufferPtr, BufferRegistry
from repro_torch.offload.dataplane import BufferDirectory, register_dataplane_handlers
from repro_torch.offload.runtime import NodeRuntime, current_node, register_internal_handlers

__all__ = [
    "OffloadDomain", "deref", "offloaded",
    "BufferPtr", "BufferRegistry", "BufferDirectory",
    "NodeRuntime", "current_node", "register_internal_handlers",
    "register_dataplane_handlers",
    "as_completed", "gather",
]
