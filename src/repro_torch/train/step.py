"""The train-step functions (port of ``repro.train.step``):
(params, opt_state, batch) -> (params, opt_state, metrics).

The reference takes gradients with ``jax.value_and_grad`` and jits the
step; here autograd takes them (``torch.autograd.grad`` over the param
leaves, which the step marks ``requires_grad``) and the step runs eagerly.
On the card the loss runs through the kernels' autograd routes (flash
attention and the grouped matmul launch their backward kernels).  A
``sharder`` or ``grad_shardings`` waits for ROADMAP Queue 1 item 13.
"""

from __future__ import annotations

import torch

from repro_torch.optim import adamw
from repro_torch.optim.adamw import tree_leaves, tree_map
from repro_torch.optim.compression import ef_compress_tree, ef_decompress_tree


def _unsharded(sharder, grad_shardings=None) -> None:
    if sharder is not None or grad_shardings is not None:
        raise NotImplementedError("sharded training waits for ROADMAP Queue 1 item 13")


def value_and_grad(model, params, batch):
    """(loss, metrics, grads): the loss, its metrics detached, and the
    gradient of every param leaf in a tree shaped like ``params``."""
    leaves = tree_leaves(params)
    for leaf in leaves:
        if not leaf.requires_grad:
            leaf.requires_grad_(True)
    loss, metrics = model.loss(params, batch)
    grads = iter(torch.autograd.grad(loss, leaves))
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            tree_map(lambda _: next(grads), params))


def build_train_step(model, opt_cfg: adamw.AdamWConfig, sharder=None,
                     grad_shardings=None):
    _unsharded(sharder, grad_shardings)

    def train_step(params, opt_state, batch):
        loss, metrics, grads = value_and_grad(model, params, batch)
        if opt_cfg.reduce_dtype is not None:
            # the reference's reduced-precision gradient reduction
            rd = getattr(torch, opt_cfg.reduce_dtype)
            grads = tree_map(lambda g: g.to(rd).float(), grads)
        params, opt_state, om = adamw.update(opt_cfg, params, opt_state, grads)
        return params, opt_state, {"loss": loss, **metrics, **om}

    return train_step


def build_compressed_train_step(model, opt_cfg: adamw.AdamWConfig, sharder=None):
    """Variant with int8 error-feedback gradient compression: the state
    carries the EF residual."""
    _unsharded(sharder)

    def train_step(params, opt_state, ef_residual, batch):
        loss, metrics, grads = value_and_grad(model, params, batch)
        qtree, ef_residual = ef_compress_tree(grads, ef_residual)
        grads = ef_decompress_tree(qtree)
        params, opt_state, om = adamw.update(opt_cfg, params, opt_state, grads)
        return params, opt_state, ef_residual, {"loss": loss, **metrics, **om}

    return train_step


def build_eval_step(model, sharder=None):
    _unsharded(sharder)

    @torch.no_grad()
    def eval_step(params, batch):
        loss, metrics = model.loss(params, batch)
        return {"loss": loss, **metrics}

    return eval_step
