"""phi3.5-moe-42b-a6.6b: 16 experts top-2 [hf:microsoft/Phi-3.5-MoE; hf]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch="phi3.5-moe-42b-a6.6b", family="moe", n_layers=32, d_model=4096,
    n_heads=32, n_kv_heads=8, d_ff=6400, vocab=32064, head_dim=128,
    n_experts=16, top_k=2,
)

SMOKE = ModelConfig(
    arch="phi3.5-moe-smoke", family="moe", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, d_ff=96, vocab=256, head_dim=16, n_experts=4, top_k=2,
    vocab_pad_multiple=64, dtype="float32",
)
