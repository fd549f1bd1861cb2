"""DTensor helpers shared by the kernel wrappers, the models, the train
step and the checkpoint store: whether a tensor is a DTensor, where its
local shard starts, and the two views (``flatten``, ``lead``) that keep a
DTensor's placements on its local shard."""

from __future__ import annotations

import math

import torch


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor (a plain tensor answers without importing
    ``torch.distributed``: the unsharded hot paths ask per leaf)."""
    if type(x) is torch.Tensor or not isinstance(x, torch.Tensor):
        return False
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def flatten(x, start: int, end: int):
    """``x.flatten(start, end)``; a DTensor flattens its local shard and keeps
    its placements (a split of dim ``start`` stays on the merged dim, the
    dims after move down).  DTensor's own view would do the same forward,
    but its backward unflattens a gradient that may come split in a way the
    leading dim cannot take (8 kv heads on a 16-way axis)."""
    if not is_dtensor(x):
        return x.flatten(start, end)
    from torch.distributed.tensor import DTensor, Shard

    start, end = start % x.ndim, end % x.ndim
    pl = []
    for q in x.placements:
        if q.is_shard() and start < q.dim <= end:
            raise NotImplementedError(f"flatten: dim {q.dim} of a {tuple(x.shape)} DTensor "
                                      f"is split inside the flattened dims {start}..{end}")
        pl.append(Shard(q.dim - (end - start)) if q.is_shard() and q.dim > end else q)
    full = (*x.shape[:start], math.prod(x.shape[start:end + 1]), *x.shape[end + 1:])
    return DTensor.from_local(x.to_local().flatten(start, end), x.device_mesh, pl,
                              run_check=False, shape=torch.Size(full), stride=_strides(full))


def lead(x, *index):
    """``x[index]`` over leading dims that are never split (a stacked
    layer's slice).  A DTensor slices its local shard and keeps the other
    dims' placements, so the slice's gradient comes back in the stack's
    own layout (DTensor's select would rebuild it in whatever layout the
    gradient has, a gathered one included)."""
    if not is_dtensor(x):
        return x[index[0]] if len(index) == 1 else x[index]
    from torch.distributed.tensor import DTensor, Shard

    n = len(index)
    pl = []
    for q in x.placements:
        if q.is_shard() and q.dim < n:
            raise NotImplementedError(f"lead: dim {q.dim} of a {tuple(x.shape)} DTensor is split")
        pl.append(Shard(q.dim - n) if q.is_shard() else q)
    return DTensor.from_local(x.to_local()[index], x.device_mesh, pl, run_check=False,
                              shape=x.shape[n:], stride=_strides(x.shape[n:]))


def _strides(shape) -> tuple:
    """The strides of a contiguous tensor of ``shape`` (computed: an
    allocation here would count in a dry-run's live bytes)."""
    out = [1] * len(shape)
    for i in range(len(shape) - 2, -1, -1):
        out[i] = out[i + 1] * shape[i + 1]
    return tuple(out)


def local_offset(t) -> tuple:
    """The global index of the DTensor ``t``'s local shard's first element,
    per dim."""
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    return compute_local_shape_and_global_offset(t.shape, t.device_mesh, t.placements)[1]
