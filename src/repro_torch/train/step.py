"""The train-step functions (port of ``repro.train.step``):
(params, opt_state, batch) -> (params, opt_state, metrics).

The reference takes gradients with ``jax.value_and_grad`` and jits the
step; here autograd takes them (``torch.autograd.grad`` over the param
leaves, which the step marks ``requires_grad``) and the step runs eagerly.
On the card the loss runs through the kernels' autograd routes (flash
attention and the grouped matmul launch their backward kernels).

With a ``sharder`` the params, moments and batch are DTensors on its mesh:
the loss runs sharded (``Model.loss(..., sharder=)``), each gradient is
redistributed to ``grad_shardings`` (a tree of placements shaped like the
params; by default each param's own placements, as the reference passes
the params' shardings), and AdamW updates the shards in place.  Plain
tensors the step makes (the step count, the schedule) count as replicated.
"""

from __future__ import annotations

import contextlib

import torch

from repro_torch.core.dtensor import is_dtensor
from repro_torch.core.trace import span
from repro_torch.optim import adamw
from repro_torch.optim.adamw import tree_leaves, tree_map
from repro_torch.optim.compression import ef_compress_tree, ef_decompress_tree


def _on_mesh(sharder):
    """DTensor's implicit replication for a sharded step's backward (which
    meets the forward's plain masks and positions) and update.  Not
    nested: the context's exit turns it off whatever was on before."""
    if sharder is None:
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication

    return implicit_replication()


def _host_value(t):
    """A metric as a plain tensor (a replicated DTensor's whole value)."""
    return t.full_tensor() if is_dtensor(t) else t


def value_and_grad(model, params, batch, sharder=None):
    """(loss, metrics, grads): the loss, its metrics detached, and the
    gradient of every param leaf in a tree shaped like ``params``."""
    leaves = tree_leaves(params)
    for leaf in leaves:
        if not leaf.requires_grad:
            leaf.requires_grad_(True)
    loss, metrics = model.loss(params, batch, sharder=sharder)   # on its mesh itself
    with _on_mesh(sharder):
        grads = iter(torch.autograd.grad(loss, leaves))
    return (_host_value(loss.detach()),
            {k: _host_value(v.detach()) for k, v in metrics.items()},
            tree_map(lambda _: next(grads), params))


def _placed(grads, params, grad_shardings):
    """Each gradient redistributed to its placements in ``grad_shardings``,
    or to its param's (a sharded gradient may come out of the backward
    as a partial sum, or split otherwise than the param it updates)."""
    def place(g, p, want=None):
        if not is_dtensor(g):
            return g
        want = tuple(p.placements if want is None else want)
        return g if tuple(g.placements) == want else g.redistribute(g.device_mesh, want)

    if grad_shardings is None:
        return tree_map(place, grads, params)
    return tree_map(place, grads, params, grad_shardings)


def build_train_step(model, opt_cfg: adamw.AdamWConfig, sharder=None,
                     grad_shardings=None):
    def train_step(params, opt_state, batch):
        loss, metrics, grads = value_and_grad(model, params, batch, sharder)
        if sharder is not None:
            grads = _placed(grads, params, grad_shardings)
        with _on_mesh(sharder), span("train.optimizer", device=model.device):
            if opt_cfg.reduce_dtype is not None:
                # the reference's reduced-precision gradient reduction
                rd = getattr(torch, opt_cfg.reduce_dtype)
                grads = tree_map(lambda g: g.to(rd).float(), grads)
            params, opt_state, om = adamw.update(opt_cfg, params, opt_state, grads)
        om = {k: _host_value(v) for k, v in om.items()}
        return params, opt_state, {"loss": loss, **metrics, **om}

    return train_step


def build_compressed_train_step(model, opt_cfg: adamw.AdamWConfig, sharder=None):
    """Variant with int8 error-feedback gradient compression: the state
    carries the EF residual."""
    def train_step(params, opt_state, ef_residual, batch):
        loss, metrics, grads = value_and_grad(model, params, batch, sharder)
        if sharder is not None:
            grads = _placed(grads, params, None)
        with _on_mesh(sharder):
            qtree, ef_residual = ef_compress_tree(grads, ef_residual)
            grads = ef_decompress_tree(qtree)
            params, opt_state, om = adamw.update(opt_cfg, params, opt_state, grads)
        om = {k: _host_value(v) for k, v in om.items()}
        return params, opt_state, ef_residual, {"loss": loss, **metrics, **om}

    return train_step


def build_eval_step(model, sharder=None):
    @torch.no_grad()
    def eval_step(params, batch):
        loss, metrics = model.loss(params, batch, sharder=sharder)
        return {"loss": _host_value(loss), **{k: _host_value(v) for k, v in metrics.items()}}

    return eval_step
