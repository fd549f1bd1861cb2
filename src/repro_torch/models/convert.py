"""Carry the reference's param and cache trees across to the port.

The reference keeps params and caches as nested dicts of arrays with the
same layouts the port uses, so conversion is leaf by leaf with no
transposes.  Feed it ``jax.tree_util.tree_map(np.asarray, tree)``: numpy
leaves, bfloat16 ones included (``ml_dtypes``, which ``torch.from_numpy``
does not read, so they pass through float32 exactly).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import torch_dtype


#: param leaves the reference keeps in float32 whatever ``param_dtype`` is
#: (``repro/models/moe.py``: the router, so routing never rounds)
FLOAT32_LEAVES = frozenset({"router"})


def _leaf(a, device, dtype):
    # always a copy: the port writes caches in place, and a reference
    # array's buffer must not change under it
    a = np.array(a, dtype=np.float32 if a.dtype.name == "bfloat16" else None)
    return torch.from_numpy(a).to(device=device, dtype=dtype)


def _convert(tree, device, dtype, name=None):
    if isinstance(tree, dict):
        return {k: _convert(v, device, dtype, k) for k, v in tree.items()}
    return _leaf(tree, device, torch.float32 if name in FLOAT32_LEAVES else dtype)


def params_from_numpy(tree, cfg: ModelConfig, device, dtype=None):
    """Reference params (numpy leaves) -> port params on ``device``, in
    ``dtype`` (default ``cfg.param_dtype``); the leaves the reference keeps
    in float32 (``FLOAT32_LEAVES``) stay float32."""
    return _convert(tree, torch.device(device), dtype or torch_dtype(cfg.param_dtype))


def cache_from_numpy(tree, cfg: ModelConfig, device, dtype=None):
    """Reference KV cache ``{k, v}`` (numpy leaves) -> port cache on
    ``device``, in ``dtype`` (default the compute dtype ``cfg.dtype``)."""
    return _convert(tree, torch.device(device), dtype or torch_dtype(cfg.dtype))
