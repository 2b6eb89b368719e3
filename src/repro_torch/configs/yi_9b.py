"""yi-9b: llama-arch dense GQA [arXiv:2403.04652; hf]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch="yi-9b", family="dense", n_layers=48, d_model=4096, n_heads=32,
    n_kv_heads=4, d_ff=11008, vocab=64000, head_dim=128, rope_theta=5e6,
)

SMOKE = ModelConfig(
    arch="yi-9b-smoke", family="dense", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, d_ff=176, vocab=256, head_dim=16, vocab_pad_multiple=64,
    dtype="float32",
)
