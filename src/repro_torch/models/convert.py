"""Carry the reference's param and cache trees across to the port.

The reference keeps params and caches as nested dicts (and, for the xLSTM
states, tuples) of arrays with the same layouts the port uses, so
conversion is leaf by leaf with no transposes.  Feed it
``jax.tree_util.tree_map(np.asarray, tree)``: numpy leaves, bfloat16 ones
included (``ml_dtypes``, which ``torch.from_numpy`` does not read, so they
pass through float32 exactly).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import torch_dtype


#: param leaves the reference keeps in float32 whatever ``param_dtype`` is:
#: the MoE router, so routing never rounds (``repro/models/moe.py``), and
#: the Mamba2 decay and skip parameters (``repro/models/mamba2.py:146-151``)
FLOAT32_LEAVES = frozenset({"router", "A_log", "dt_bias", "D"})
#: cache leaves the reference keeps in float32 whatever ``cfg.dtype`` is:
#: the xLSTM cell states, mLSTM (C, n, m) and sLSTM (c, n, m), and the
#: Mamba2 SSM state h, by their position in the state tuple
#: (``repro/models/xlstm.py:287-292, :400-406``, ``mamba2.py:220``)
FLOAT32_CACHE_LEAVES = {"mlstm": (0, 1, 2), "slstm": (1, 2, 3), "mamba": (0,)}
#: the int8 ``kv_quant`` cache's scales, float32 (``transformer.py:195-202``);
#: its int8 ``k``/``v`` stay int8
FLOAT32_CACHE_NAMES = frozenset({"k_scale", "v_scale"})


def _leaf(a, device, dtype):
    # always a copy: the port writes caches in place, and a reference
    # array's buffer must not change under it
    a = np.array(a, dtype=np.float32 if a.dtype.name == "bfloat16" else None)
    return torch.from_numpy(a).to(device=device, dtype=dtype)


def _convert(tree, device, dtype, keep32, path=()):
    """Convert every leaf of nested dicts and tuples; ``keep32(path)`` says
    which leaves stay float32, and int8 leaves stay int8."""
    if isinstance(tree, dict):
        return {k: _convert(v, device, dtype, keep32, (*path, k)) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_convert(v, device, dtype, keep32, (*path, i))
                          for i, v in enumerate(tree))
    if tree.dtype == np.int8:
        return _leaf(tree, device, torch.int8)
    return _leaf(tree, device, torch.float32 if keep32(path) else dtype)


def params_from_numpy(tree, cfg: ModelConfig, device, dtype=None):
    """Reference params (numpy leaves) -> port params on ``device``, in
    ``dtype`` (default ``cfg.param_dtype``); the leaves the reference keeps
    in float32 (``FLOAT32_LEAVES``) stay float32."""
    return _convert(tree, torch.device(device), dtype or torch_dtype(cfg.param_dtype),
                    lambda path: path[-1] in FLOAT32_LEAVES)


def cache_from_numpy(tree, cfg: ModelConfig, device, dtype=None):
    """Reference cache (numpy leaves: a KV cache ``{k, v}``, an int8 one
    ``{k, v, k_scale, v_scale}``, the xLSTM states, the Zamba2 ``{mamba,
    attn_kv}`` or the Whisper ``{self, cross}`` cache) -> port cache on
    ``device``, in ``dtype`` (default the compute dtype ``cfg.dtype``); the
    leaves the reference keeps in float32 (``FLOAT32_CACHE_LEAVES``,
    ``FLOAT32_CACHE_NAMES``) stay float32 and int8 leaves stay int8."""
    def keep32(path):
        return (path[-1] in FLOAT32_CACHE_NAMES
                or len(path) == 2 and path[1] in FLOAT32_CACHE_LEAVES.get(path[0], ()))

    return _convert(tree, torch.device(device), dtype or torch_dtype(cfg.dtype), keep32)
