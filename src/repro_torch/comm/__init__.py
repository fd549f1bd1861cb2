"""Communication backends for HAM (paper Fig. 1: MPI/TCP/SCIF/VEO -> here
local/shm/socket).  Frames are opaque; all semantics live in repro_torch.core."""

from repro_torch.comm.base import CommBackend, Fabric
from repro_torch.comm.local import LocalEndpoint, LocalFabric
from repro_torch.comm.shm import ShmEndpoint, ShmFabric, ShmRing
from repro_torch.comm.socket import SocketEndpoint, SocketFabric

__all__ = [
    "CommBackend", "Fabric",
    "LocalEndpoint", "LocalFabric",
    "ShmEndpoint", "ShmFabric", "ShmRing",
    "SocketEndpoint", "SocketFabric",
]
