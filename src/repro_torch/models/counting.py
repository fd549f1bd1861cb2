"""Parameter and FLOP accounting (port of ``repro.models.counting``).

MODEL_FLOPS convention, as the reference's:
* train cells:            6 · N_active · tokens   (fwd 2ND + bwd 4ND)
* prefill/decode cells:   2 · N_active · tokens
Attention's quadratic term is intentionally not in MODEL_FLOPS.

Shapes come from each family's init run on the ``meta`` device, which
allocates nothing (the reference uses ``jax.eval_shape``).
"""

from __future__ import annotations

import functools
import math

from repro_torch.optim.adamw import tree_leaves


@functools.lru_cache(maxsize=64)
def _shapes_for(cfg):
    from repro_torch.models import transformer as T
    from repro_torch.models import whisper as W
    from repro_torch.models import xlstm as X
    from repro_torch.models import zamba2 as Z

    init = {"ssm": X.xlstm_init, "hybrid": Z.zamba2_init,
            "audio": W.whisper_init}.get(cfg.family, T.lm_init)
    return init(cfg, device="meta", generator=None)


def count_params(cfg) -> int:
    return int(sum(math.prod(leaf.shape) for leaf in tree_leaves(_shapes_for(cfg))))


def count_active_params(cfg) -> int:
    """Active parameters per token (MoE: routed experts scaled by
    top_k / E; Zamba2's shared attention block counted once)."""
    total = count_params(cfg)
    if cfg.moe is None:
        return total
    shapes = _shapes_for(cfg)
    moe_tree = shapes["layers"].get("moe") if isinstance(shapes, dict) else None
    routed = 0
    if moe_tree is not None:
        for name in ("w_gate", "w_up", "w_down"):
            routed += math.prod(moe_tree[name].shape)
    frac = cfg.moe.top_k / cfg.moe.num_experts
    return int(total - routed * (1.0 - frac))


def model_flops(cfg, cell) -> float:
    n = count_active_params(cfg)
    if cell.kind == "train":
        return 6.0 * n * cell.seq_len * cell.global_batch
    if cell.kind == "prefill":
        return 2.0 * n * cell.seq_len * cell.global_batch
    return 2.0 * n * cell.global_batch   # decode: one token per sequence per step
