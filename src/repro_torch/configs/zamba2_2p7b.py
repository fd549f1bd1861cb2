"""zamba2-2.7b [hybrid]: 54L d=2560, Mamba2 (ssm_state=64) + shared attn
block (32H kv=32, d_ff=10240) every 6 layers [arXiv:2411.15242]."""
from repro_torch.models.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b", family="hybrid", num_layers=54, d_model=2560,
    num_heads=32, num_kv_heads=32, d_ff=10240, vocab_size=32000,
    ssm=SSMConfig(state_dim=64, head_dim=64, num_groups=1, chunk_size=256,
                  conv_width=4, expand=2, attn_every=6, attn_window=None),
)

REDUCED = ModelConfig(
    name="zamba2-2.7b-reduced", family="hybrid", num_layers=4, d_model=32,
    num_heads=4, num_kv_heads=4, d_ff=64, vocab_size=128,
    dtype="float32", param_dtype="float32", remat="none",
    ssm=SSMConfig(state_dim=8, head_dim=8, num_groups=2, chunk_size=8,
                  conv_width=4, expand=2, attn_every=2, attn_window=None),
)
