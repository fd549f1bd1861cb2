"""hamlint fixture: torch handlers HAM001 must pass — a mutates=True
handler's in-place ``add_`` (the declared write), and read_only=True
handlers that only read buffer memory: out-of-place ops, copies written in
place, a local accumulator, metadata.  Never imported — parsed by the
linter only."""

import torch

from repro_torch.core.registry import default_registry
from repro_torch.offload.api import deref

_reg = default_registry()


@_reg.handler(name="ok/torch_declared_add", mutates=True)
def declared_add(alpha, x_ptr, y_ptr):
    y = torch.from_numpy(deref(y_ptr))
    y.add_(torch.from_numpy(deref(x_ptr)), alpha=alpha)   # declared: no finding
    return None


@_reg.handler(name="ok/torch_reads", read_only=True)
def reads(x_ptr, n):
    x = torch.from_numpy(deref(x_ptr))
    scaled = x.add(1.0).mul_(2.0)          # out-of-place add: a new tensor
    copy = x.clone()
    copy.zero_()                           # writes the copy
    acc = torch.zeros(n)
    acc.add_(x[:n])                        # writes the local accumulator
    rows = x.shape[0]
    rows += 1                              # metadata, not memory
    first = float(x[0])
    first += 1.0                           # a Python float
    return float(scaled.sum()) + float(acc.sum()) + rows + first
