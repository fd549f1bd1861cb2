"""hamlint fixture: handler declared read_only=True that mutates and
alias-escapes buffer-derived memory (the PR 5 bug class).  Never imported —
parsed by the linter only."""

from repro_torch.core.registry import default_registry
from repro_torch.offload.api import deref

_reg = default_registry()

_stash = {}


@_reg.handler(name="bad/scale_in_place", read_only=True)
def scale_in_place(alpha, x_ptr, y_ptr):
    y = deref(y_ptr)
    y += alpha * deref(x_ptr)          # in-place mutation
    return None


@_reg.handler(name="bad/store_through_view", read_only=True)
def store_through_view(x_ptr):
    row = deref(x_ptr)[0]
    row[:] = 0.0                       # store through a view
    return None


@_reg.handler(name="bad/alias_escape", read_only=True)
def alias_escape(x_ptr):
    _stash["x"] = deref(x_ptr)         # view outlives the call
    return None
