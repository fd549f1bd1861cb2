"""olmoe-1b-7b [moe]: 16L d=2048 16H d_ff=1024/expert, 64 experts top-8
[arXiv:2409.02060]."""
from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b", family="moe", num_layers=16, d_model=2048,
    num_heads=16, num_kv_heads=16, d_ff=1024, vocab_size=50304,
    moe=MoEConfig(num_experts=64, top_k=8, d_ff_expert=1024,
                  capacity_factor=1.25, expert_parallel=True),
)

REDUCED = ModelConfig(
    name="olmoe-1b-7b-reduced", family="moe", num_layers=2, d_model=32,
    num_heads=4, num_kv_heads=4, d_ff=16, vocab_size=128,
    dtype="float32", param_dtype="float32", remat="none",
    moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=16,
                  capacity_factor=2.0, expert_parallel=True),
)
