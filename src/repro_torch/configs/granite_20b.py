"""granite-20b: llama-arch dense, MQA (kv=1), code model [arXiv:2405.04324; hf]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch="granite-20b", family="dense", n_layers=52, d_model=6144, n_heads=48,
    n_kv_heads=1, d_ff=24576, vocab=49152, head_dim=128, act="gelu",
)

SMOKE = ModelConfig(
    arch="granite-20b-smoke", family="dense", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=1, d_ff=256, vocab=256, head_dim=16, act="gelu",
    vocab_pad_multiple=64, dtype="float32",
)
