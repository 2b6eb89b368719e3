"""whisper-small: enc-dec audio backbone; conv frontend is a stub
[arXiv:2212.04356; unverified].  12L refers to each stack."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch="whisper-small", family="encdec", n_layers=12, d_model=768, n_heads=12,
    n_kv_heads=12, d_ff=3072, vocab=51865, head_dim=64, enc_layers=12,
    enc_seq=1500, norm_kind="layer", act="gelu",
)

SMOKE = ModelConfig(
    arch="whisper-small-smoke", family="encdec", n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=4, d_ff=128, vocab=256, head_dim=16, enc_layers=2,
    enc_seq=16, norm_kind="layer", act="gelu", vocab_pad_multiple=64,
    dtype="float32",
)
