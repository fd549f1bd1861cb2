"""internlm2-20b [dense]: 48L d=6144 48H (GQA kv=8) d_ff=16384 vocab=92544
[arXiv:2403.17297]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internlm2-20b", family="dense", num_layers=48, d_model=6144,
    num_heads=48, num_kv_heads=8, d_ff=16384, vocab_size=92544,
    mlp="swiglu", rope_theta=1_000_000.0,
)

REDUCED = ModelConfig(
    name="internlm2-20b-reduced", family="dense", num_layers=2, d_model=64,
    num_heads=8, num_kv_heads=2, d_ff=128, vocab_size=128,
    mlp="swiglu", dtype="float32", param_dtype="float32", remat="none",
)
