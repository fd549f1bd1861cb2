"""llama3-405b [dense]: 126L d=16384 128H (GQA kv=8) d_ff=53248
vocab=128256 [arXiv:2407.21783]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama3-405b", family="dense", num_layers=126, d_model=16384,
    num_heads=128, num_kv_heads=8, d_ff=53248, vocab_size=128256,
    mlp="swiglu", rope_theta=500_000.0,
)

REDUCED = ModelConfig(
    name="llama3-405b-reduced", family="dense", num_layers=3, d_model=64,
    num_heads=8, num_kv_heads=2, d_ff=192, vocab_size=128,
    dtype="float32", param_dtype="float32", remat="none",
)
