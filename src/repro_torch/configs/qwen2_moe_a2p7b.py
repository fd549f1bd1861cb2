"""qwen2-moe-a2.7b [moe]: 24L d=2048 16H, 60 routed top-4 + 4 shared experts
d_ff=1408 [hf:Qwen/Qwen1.5-MoE-A2.7B].  60 experts do not divide the 16-way
model axis -> TP-in-expert sharding (DESIGN.md §5)."""
from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b", family="moe", num_layers=24, d_model=2048,
    num_heads=16, num_kv_heads=16, d_ff=1408, vocab_size=151936,
    moe=MoEConfig(num_experts=60, top_k=4, d_ff_expert=1408,
                  num_shared_experts=4, capacity_factor=1.25,
                  expert_parallel=False),
)

REDUCED = ModelConfig(
    name="qwen2-moe-a2.7b-reduced", family="moe", num_layers=2, d_model=32,
    num_heads=4, num_kv_heads=4, d_ff=16, vocab_size=128,
    dtype="float32", param_dtype="float32", remat="none",
    moe=MoEConfig(num_experts=6, top_k=2, d_ff_expert=16,
                  num_shared_experts=2, capacity_factor=2.0,
                  expert_parallel=False),
)
