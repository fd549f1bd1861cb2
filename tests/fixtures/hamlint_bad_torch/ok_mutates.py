"""hamlint fixture: handler declared mutates=True whose in-place store is
LEGAL — the declaration is the point of the Active Access write path (the
scheduler routes the call at the primary and invalidates replicas on
completion), so HAM001 must produce NO finding here.  Never imported —
parsed by the linter only."""

from repro_torch.core.registry import default_registry
from repro_torch.offload.api import deref


_reg = default_registry()


@_reg.handler(name="ok/declared_scale", mutates=True)
def declared_scale(alpha, y_ptr):
    y = deref(y_ptr)
    y *= alpha                         # declared: no finding
    return None
