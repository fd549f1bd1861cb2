"""xlstm-1.3b [ssm]: 48L d_model=2048 4H, vocab 50304 — sLSTM + mLSTM 7:1
[arXiv:2405.04517]."""
from repro_torch.models.config import ModelConfig, XLSTMConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b", family="ssm", num_layers=48, d_model=2048,
    num_heads=4, num_kv_heads=4, d_ff=0, vocab_size=50304,
    xlstm=XLSTMConfig(mlstm_per_group=7, slstm_per_group=1, chunk_size=256,
                      proj_factor=2.0, conv_width=4),
)

REDUCED = ModelConfig(
    name="xlstm-1.3b-reduced", family="ssm", num_layers=4, d_model=64,
    num_heads=4, num_kv_heads=4, d_ff=0, vocab_size=128,
    dtype="float32", param_dtype="float32", remat="none",
    xlstm=XLSTMConfig(mlstm_per_group=3, slstm_per_group=1, chunk_size=8,
                      proj_factor=2.0, conv_width=4),
)
