"""nemotron-4-340b [dense]: 96L d=18432 96H (GQA kv=8) d_ff=73728
vocab=256000, squared-ReLU MLP [arXiv:2402.16819]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-340b", family="dense", num_layers=96, d_model=18432,
    num_heads=96, num_kv_heads=8, d_ff=73728, vocab_size=256000,
    mlp="relu2", rope_theta=10_000.0,
)

REDUCED = ModelConfig(
    name="nemotron-4-340b-reduced", family="dense", num_layers=2, d_model=48,
    num_heads=6, num_kv_heads=2, d_ff=192, vocab_size=128,
    mlp="relu2", dtype="float32", param_dtype="float32", remat="none",
)
