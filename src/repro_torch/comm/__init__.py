"""Communication backends of the port (frames are opaque; all semantics live
in ``repro_torch.core``).  The in-process fabric is ported; the shm, socket
and chaos fabrics are ROADMAP item 11b."""

from repro_torch.comm.base import CommBackend, Fabric
from repro_torch.comm.local import LocalEndpoint, LocalFabric

__all__ = ["CommBackend", "Fabric", "LocalEndpoint", "LocalFabric"]
