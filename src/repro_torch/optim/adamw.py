"""AdamW with global-norm clipping over a param tree (port of
``repro.optim.adamw``).

``init``/``update`` keep the reference's names and math: each leaf's
moments and update are computed in float32, the moments stored in
``state_dtype``.  The reference jits the step with ``donate_argnums=(0, 1)``
so the new params and state reuse the old buffers; here ``update`` writes
them in place under ``torch.no_grad()`` to the same effect, and still
returns ``(params, opt_state, metrics)``.  Trees are nested dicts (and
tuples) of tensors, walked in sorted-key order as ``jax.tree_util`` walks
them.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    # reduce_dtype: gradients pass through this dtype before the update (the
    # reference's reduced-precision DP reduction); state_dtype: Adam moments
    reduce_dtype: str | None = None
    state_dtype: str = "float32"


def tree_leaves(tree) -> list:
    """The leaves of ``tree`` in ``jax.tree_util`` order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [leaf for t in tree for leaf in tree_leaves(t)]
    return [tree]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of ``rest``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in sorted(tree)}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


def init(params, *, state_dtype: str = "float32") -> dict:
    sd = getattr(torch, state_dtype)
    zeros = lambda p: torch.zeros_like(p, dtype=sd)   # a DTensor's moments: its placements
    device = tree_leaves(params)[0].device
    return {
        "mu": tree_map(zeros, params),
        "nu": tree_map(zeros, params),
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }


def _schedule(cfg: AdamWConfig, step):
    warm = torch.clamp(step.float() / max(cfg.warmup_steps, 1), max=1.0)
    return cfg.lr * warm


def global_norm(tree) -> torch.Tensor:
    total = 0
    for leaf in tree_leaves(tree):
        total = total + leaf.float().square().sum()
    return torch.sqrt(total)


@torch.no_grad()
def update(cfg: AdamWConfig, params, opt_state, grads):
    """Returns (params, opt_state, metrics): params and the moments updated
    in place, ``opt_state["step"]`` a new tensor."""
    step = opt_state["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    lr = _schedule(cfg, step)
    stepf = step.float()
    c1, c2 = 1 - cfg.b1 ** stepf, 1 - cfg.b2 ** stepf
    for p, m, v, g in zip(tree_leaves(params), tree_leaves(opt_state["mu"]),
                          tree_leaves(opt_state["nu"]), tree_leaves(grads)):
        g = g.float() * scale
        m32 = cfg.b1 * m.float() + (1 - cfg.b1) * g
        v32 = cfg.b2 * v.float() + (1 - cfg.b2) * g.square()
        del g
        upd = (m32 / c1) / ((v32 / c2).sqrt() + cfg.eps) + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * upd)
        m.copy_(m32)
        v.copy_(v32)
    opt_state["step"] = step
    return params, opt_state, {"grad_norm": gnorm, "lr": lr}
