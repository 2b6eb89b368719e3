"""mamba2-1.3b: SSD state-space model, attention-free [arXiv:2405.21060]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch="mamba2-1.3b", family="ssm", n_layers=48, d_model=2048, n_heads=0,
    n_kv_heads=0, d_ff=0, vocab=50280, ssm_state=128, ssm_headdim=64,
    ssm_groups=1, tie_embeddings=True, subquadratic=True,
)

SMOKE = ModelConfig(
    arch="mamba2-smoke", family="ssm", n_layers=2, d_model=64, n_heads=0,
    n_kv_heads=0, d_ff=0, vocab=256, ssm_state=16, ssm_headdim=16,
    ssm_groups=2, tie_embeddings=True, vocab_pad_multiple=64,
    dtype="float32", subquadratic=True,
)
