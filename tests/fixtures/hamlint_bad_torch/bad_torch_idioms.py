"""hamlint fixture: handlers declared read_only=True that write through
buffer memory the ways torch does (the PR 5 bug class, torch idioms).
Each marked line is one HAM001 finding.  Never imported — parsed by the
linter only."""

import torch
import torch.nn.functional as F

from repro_torch.core.registry import default_registry
from repro_torch.offload.api import deref

_reg = default_registry()


@_reg.handler(name="bad/torch_copy", read_only=True)
def copy_into(y_ptr, x):
    y = torch.from_numpy(deref(y_ptr))
    y.copy_(x)                                      # trailing-underscore method
    return None


@_reg.handler(name="bad/torch_zero_returned", read_only=True)
def zero_returned(y_ptr):
    return torch.as_tensor(deref(y_ptr)).zero_()    # in-place inside a return


@_reg.handler(name="bad/torch_narrow", read_only=True)
def narrow_add(y_ptr):
    head = torch.from_numpy(deref(y_ptr)).narrow(0, 0, 1)
    head.add_(1.0)                                  # write through a narrow view
    return None


@_reg.handler(name="bad/torch_select", read_only=True)
def select_store(y_ptr):
    row = torch.from_numpy(deref(y_ptr)).select(0, 0)
    row[:] = 0.0                                    # store through a select view
    return None


@_reg.handler(name="bad/torch_detach", read_only=True)
def detach_alias(y_ptr):
    y = torch.from_numpy(deref(y_ptr)).detach()
    y.mul_(2.0)                                     # detach() aliases its receiver
    return None


@_reg.handler(name="bad/torch_contiguous", read_only=True)
def contiguous_chain(y_ptr):
    torch.from_numpy(deref(y_ptr)).contiguous().mul_(2)  # contiguous() may return self
    return None


@_reg.handler(name="bad/torch_from_numpy", read_only=True)
def from_numpy_aug(y_ptr):
    t = torch.from_numpy(deref(y_ptr))
    t += 1.0                                        # from_numpy shares the memory
    return None


@_reg.handler(name="bad/torch_init", read_only=True)
def init_normal(w_ptr):
    torch.nn.init.normal_(torch.from_numpy(deref(w_ptr)))  # in-place free function
    return None


@_reg.handler(name="bad/torch_chunk", read_only=True)
def chunk_fill(y_ptr):
    lo, hi = torch.from_numpy(deref(y_ptr)).chunk(2)
    hi.fill_(0.0)                                   # chunk() returns views
    return None


@_reg.handler(name="bad/torch_relu", read_only=True)
def relu_inplace(y_ptr):
    F.relu(torch.from_numpy(deref(y_ptr)), inplace=True)  # inplace=True
    return None


@_reg.handler(name="bad/torch_index_put")
def undeclared_index_put(y_ptr, idx, vals):
    y = torch.from_numpy(deref(y_ptr))
    y.index_put_((idx,), vals)                      # undeclared in-place write
    return None
