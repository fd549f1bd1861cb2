"""hamlint fixture: handler that mutates buffer memory while declaring
NEITHER read_only nor mutates — the write lands on the primary but its
replicas are never invalidated, so a replica-served read observes stale
bytes.  The finding must name the fix: declare mutates=True.  Never
imported — parsed by the linter only."""

from repro_torch.core.registry import default_registry
from repro_torch.offload.api import deref


_reg = default_registry()


@_reg.handler(name="bad/undeclared_scale")
def undeclared_scale(alpha, y_ptr):
    y = deref(y_ptr)
    y *= alpha                         # undeclared in-place mutation
    return None
