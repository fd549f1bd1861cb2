"""Model and sharding configuration (a copy of ``repro.models.config``).

One :class:`ModelConfig` describes any of the assigned architectures; family
subconfigs switch in MoE / xLSTM / SSM / enc-dec / VLM behaviour.  The port
reads the same fields as the reference, so a reference config and its copy
here describe the same model.  ``param_count``/``active_param_count`` count
from shapes on the ``meta`` device (``models.counting``).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    num_shared_experts: int = 0
    capacity_factor: float = 1.25
    router_jitter: float = 0.0
    # EP shards the expert dim over the model axis (needs divisibility);
    # TP-in-expert shards d_ff_expert instead (e.g. qwen2-moe's 60 experts)
    expert_parallel: bool = True


@dataclasses.dataclass(frozen=True)
class XLSTMConfig:
    # ratio of mLSTM to sLSTM blocks, e.g. 7:1 (xLSTM[7:1] of the paper)
    mlstm_per_group: int = 7
    slstm_per_group: int = 1
    chunk_size: int = 256          # chunkwise-parallel mLSTM chunk length
    proj_factor: float = 2.0       # mLSTM up-projection factor
    qk_factor: float = 0.5         # d_qk = qk_factor * d_inner (xLSTM-7B layout)
    conv_width: int = 4


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 64            # N (ssm_state)
    head_dim: int = 64             # P
    num_groups: int = 1            # B/C groups (GVA-style)
    chunk_size: int = 256
    conv_width: int = 4
    expand: int = 2                # d_inner = expand * d_model
    # hybrid (zamba2): one shared attention block every `attn_every` ssm
    # blocks, attention weights SHARED across all applications
    attn_every: int = 6
    attn_window: int | None = None  # sliding window for long-context cells


@dataclasses.dataclass(frozen=True)
class EncDecConfig:
    encoder_layers: int = 32
    encoder_frames: int = 1500     # whisper: fixed 30 s -> 1500 frames (stub)


@dataclasses.dataclass(frozen=True)
class VLMConfig:
    num_patches: int = 256         # patch embeddings prepended to text (stub)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int | None = None
    qkv_bias: bool = False
    mlp: str = "swiglu"            # swiglu | relu2
    rope_theta: float = 500_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    moe: MoEConfig | None = None
    xlstm: XLSTMConfig | None = None
    ssm: SSMConfig | None = None
    encdec: EncDecConfig | None = None
    vlm: VLMConfig | None = None
    # numerics
    dtype: str = "bfloat16"        # activation/compute dtype
    param_dtype: str = "float32"
    # perf levers (hillclimbed in §Perf)
    remat: str = "full"            # none | full | dots_saveable
    remat_group: int = 1           # layers per remat block (saves L/g acts)
    attn_impl: str = "ref"         # read by the reference's roofline only
    attn_chunk: int = 1024         # q-chunked attention above this seq len
    attn_causal_skip: bool = False  # per-chunk growing kv extent (§Perf)
    kv_quant: bool = False          # int8 KV cache with per-vector scales
    scan_layers: bool = True

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // self.num_kv_heads

    def param_count(self) -> int:
        """Total parameters (for MODEL_FLOPS and checkpoint sizing)."""
        from repro_torch.models.counting import count_params

        return count_params(self)

    def active_param_count(self) -> int:
        from repro_torch.models.counting import count_active_params

        return count_active_params(self)


@dataclasses.dataclass(frozen=True)
class ShardingPlan:
    """How a config maps onto the production mesh.

    Axis names refer to the mesh from ``launch.mesh.make_production_mesh``:
    ``("data", "model")`` single-pod or ``("pod", "data", "model")``
    multi-pod.  The ``pod`` axis, when present, is folded into the batch
    axes (pure DP across pods — minimal inter-pod traffic) unless
    ``pod_in_model`` is set.
    """

    batch_axes: tuple = ("pod", "data")
    model_axis: str = "model"
    # FSDP: additionally shard each weight's largest replicated dim over the
    # batch axes (ZeRO-3 style); required for the 405B/340B configs
    fsdp: bool = False
    fsdp_axes: tuple = ("data",)
    # sequence parallelism: shard activations' seq dim over model axis where
    # attention allows (long-context cells)
    seq_shard: bool = False
    pod_in_model: bool = False
    # gradient all-reduce in lower precision (distributed-optimisation trick)
    grad_reduce_dtype: str | None = None


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    """One assigned (shape) cell: what gets lowered in the dry-run."""

    name: str                      # train_4k | prefill_32k | decode_32k | long_500k
    kind: str                      # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPE_CELLS = (
    ShapeCell("train_4k", "train", 4_096, 256),
    ShapeCell("prefill_32k", "prefill", 32_768, 32),
    ShapeCell("decode_32k", "decode", 32_768, 128),
    ShapeCell("long_500k", "decode", 524_288, 1),
)


def shape_cell(name: str) -> ShapeCell:
    for c in SHAPE_CELLS:
        if c.name == name:
            return c
    raise KeyError(name)


def supports_cell(cfg: ModelConfig, cell: ShapeCell) -> tuple[bool, str]:
    """(runnable, reason-if-not).  Pure full-attention archs skip long_500k
    (quadratic attention at 524k seq is not meaningfully lowerable); SSM and
    hybrid archs run it (recurrent state decode)."""
    if cell.name == "long_500k" and cfg.family not in ("ssm", "hybrid"):
        return False, "pure full-attention arch: long_500k skipped (DESIGN.md §5)"
    return True, ""


def cells_for(cfg: ModelConfig):
    return [(c, *supports_cell(cfg, c)) for c in SHAPE_CELLS]
