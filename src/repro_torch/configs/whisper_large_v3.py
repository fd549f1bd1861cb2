"""whisper-large-v3 [audio]: enc-dec 32L d=1280 20H d_ff=5120 vocab=51866;
conv/mel frontend is a STUB (precomputed 1500-frame embeddings)
[arXiv:2212.04356]."""
from repro_torch.models.config import EncDecConfig, ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3", family="audio", num_layers=32, d_model=1280,
    num_heads=20, num_kv_heads=20, d_ff=5120, vocab_size=51866,
    mlp="gelu", encdec=EncDecConfig(encoder_layers=32, encoder_frames=1500),
)

REDUCED = ModelConfig(
    name="whisper-large-v3-reduced", family="audio", num_layers=2, d_model=40,
    num_heads=4, num_kv_heads=4, d_ff=80, vocab_size=128,
    mlp="gelu", dtype="float32", param_dtype="float32", remat="none",
    encdec=EncDecConfig(encoder_layers=2, encoder_frames=16),
)
