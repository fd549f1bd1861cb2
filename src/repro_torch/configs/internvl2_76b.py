"""internvl2-76b [vlm]: 80L d=8192 64H (GQA kv=8) d_ff=28672 vocab=128256 —
InternViT frontend is a STUB (precomputed patch embeddings)
[arXiv:2404.16821]."""
from repro_torch.models.config import ModelConfig, VLMConfig

CONFIG = ModelConfig(
    name="internvl2-76b", family="vlm", num_layers=80, d_model=8192,
    num_heads=64, num_kv_heads=8, d_ff=28672, vocab_size=128256,
    mlp="swiglu", rope_theta=1_000_000.0, vlm=VLMConfig(num_patches=256),
)

REDUCED = ModelConfig(
    name="internvl2-76b-reduced", family="vlm", num_layers=2, d_model=64,
    num_heads=8, num_kv_heads=2, d_ff=128, vocab_size=128,
    dtype="float32", param_dtype="float32", remat="none",
    vlm=VLMConfig(num_patches=4),
)
