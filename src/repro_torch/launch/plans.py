"""Per-(arch x cell) sharding plans and dry-run config tuning (port of
``repro.launch.plans``; pure config, equal to the reference's for every
arch and cell).

Deviations per arch from the plain plan:

* 405B / 340B / 76B-VLM: FSDP over the batch axes + bf16 params + bf16 Adam
  moments (fp32 master math in-step) + grouped remat + sequence-sharded
  residual stream.
* qwen2-moe (60 experts vs 16-way axis): TP-in-expert instead of EP.
* zamba2 long_500k: shared-attention block runs a 4096 sliding window.
* whisper / qwen1.5 (20 heads vs 16-way axis): attention stays replicated
  on the model axis (divisibility fallback), FFN/vocab still shard.
"""

from __future__ import annotations

import dataclasses

from repro_torch.configs import get_config
from repro_torch.models.config import ModelConfig, ShapeCell, ShardingPlan

_GIANT = {"llama3-405b", "nemotron-4-340b", "internvl2-76b"}

# remat_group must divide num_layers
_REMAT_GROUP = {"llama3-405b": 7, "nemotron-4-340b": 8, "internvl2-76b": 8}


def plan_for(arch: str, cell: ShapeCell, *, multi_pod: bool = False) -> ShardingPlan:
    # FSDP on every train cell (optimizer + param shards over the batch
    # axes); serving keeps params TP-only: a per-step all-gather of the
    # whole model would dominate decode latency
    fsdp = cell.kind == "train"
    fsdp_axes = ("pod", "data") if multi_pod else ("data",)
    seq_shard = arch in _GIANT and cell.kind == "train"
    return ShardingPlan(
        batch_axes=("pod", "data"),
        model_axis="model",
        fsdp=fsdp,
        fsdp_axes=fsdp_axes,
        seq_shard=seq_shard,
    )


def tuned_config(arch: str, cell: ShapeCell) -> ModelConfig:
    cfg = get_config(arch)
    rep: dict = {}
    if cell.kind == "train":
        rep["remat"] = "full"
        if arch in _REMAT_GROUP:
            rep["remat_group"] = _REMAT_GROUP[arch]
    else:
        rep["remat"] = "none"
        # serving in bf16 weights halves weight HBM
        rep["param_dtype"] = "bfloat16"
    if arch in _GIANT:
        rep["param_dtype"] = "bfloat16"
    if arch == "zamba2-2.7b" and cell.name == "long_500k":
        rep["ssm"] = dataclasses.replace(cfg.ssm, attn_window=4096)
    return dataclasses.replace(cfg, **rep)


def opt_state_dtype(arch: str) -> str:
    return "bfloat16" if arch in _GIANT else "float32"
