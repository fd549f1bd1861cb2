"""Exception hierarchy for the HAM core.

The paper relies on C++ compile-time errors (e.g. the ``is_bitwise_copyable``
trait triggering ``static_assert``-style diagnostics).  In Python we surface
the same classes of failure as early, typed exceptions raised at registration
or closure-construction time — *before* any message crosses an address space.
"""

from __future__ import annotations


class HamError(Exception):
    """Base class for all HAM errors."""


class RegistryError(HamError):
    """Handler registry misuse (duplicate names, unsealed access, ...)."""


class RegistrySealedError(RegistryError):
    """Registration attempted after ``init()`` sealed the registry."""


class UnstableNameError(RegistryError):
    """A handler's auto-derived stable name is not stable across processes.

    The Python analogue of the paper's lambda caveat (§5.1/§6): compiler
    internal names (``_FUN`` vs ``__invoke``) differ between binaries; here,
    ``<lambda>`` / ``<locals>`` qualnames differ between refactors and
    interactive sessions.  An explicit ``name=`` resolves it (the ``l2f``
    route).
    """


class KeyMapMismatchError(HamError):
    """Two processes derived different key maps (digest handshake failed)."""


class MigratableError(HamError):
    """A value cannot be migrated between address spaces."""


class NotBitwiseMigratableError(MigratableError):
    """Type lacks a codec and is not bitwise-copyable (paper's trait trip)."""


class SpecMismatchError(MigratableError):
    """Runtime argument does not match the handler's declared static spec."""


class MessageFormatError(HamError):
    """Malformed frame: bad magic, truncated payload, unknown version."""


class UnknownHandlerError(HamError):
    """Received a key outside the local handler table."""


class CommError(HamError):
    """Transport-level failure in a communication backend."""


class NodeDownError(CommError):
    """Peer declared dead (missed heartbeats / closed transport)."""


class OffloadError(HamError):
    """Offload-layer failure (bad node id, freed buffer, ...)."""


class RemoteExecutionError(HamError):
    """The remote handler raised; carries the remote traceback string."""

    def __init__(self, message: str, remote_traceback: str = ""):
        super().__init__(message)
        self.remote_traceback = remote_traceback
