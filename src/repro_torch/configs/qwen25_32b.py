"""qwen2.5-32b: dense GQA with QKV bias [hf:Qwen/Qwen2.5; hf]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch="qwen2.5-32b", family="dense", n_layers=64, d_model=5120, n_heads=40,
    n_kv_heads=8, d_ff=27648, vocab=152064, head_dim=128, qkv_bias=True,
    rope_theta=1e6,
)

SMOKE = ModelConfig(
    arch="qwen2.5-32b-smoke", family="dense", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, d_ff=192, vocab=256, head_dim=16, qkv_bias=True,
    vocab_pad_multiple=64, dtype="float32",
)
