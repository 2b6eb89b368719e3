"""olmoe-1b-7b: 64 experts top-8 [arXiv:2409.02060; hf]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch="olmoe-1b-7b", family="moe", n_layers=16, d_model=2048, n_heads=16,
    n_kv_heads=16, d_ff=1024, vocab=50304, head_dim=128, n_experts=64, top_k=8,
)

SMOKE = ModelConfig(
    arch="olmoe-smoke", family="moe", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=4, d_ff=64, vocab=256, head_dim=16, n_experts=8, top_k=2,
    vocab_pad_multiple=64, dtype="float32",
)
