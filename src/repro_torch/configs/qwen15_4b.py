"""qwen1.5-4b [dense]: 40L d=2560 20H (kv=20) d_ff=6912 vocab=151936, QKV
bias [hf:Qwen/Qwen1.5-*]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-4b", family="dense", num_layers=40, d_model=2560,
    num_heads=20, num_kv_heads=20, d_ff=6912, vocab_size=151936,
    qkv_bias=True, mlp="swiglu", rope_theta=1_000_000.0,
)

REDUCED = ModelConfig(
    name="qwen1.5-4b-reduced", family="dense", num_layers=2, d_model=40,
    num_heads=5, num_kv_heads=5, d_ff=96, vocab_size=128,
    qkv_bias=True, dtype="float32", param_dtype="float32", remat="none",
)
