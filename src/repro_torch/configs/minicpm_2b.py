"""minicpm-2b: llama-like dense MHA, tied embeddings, WSD schedule
[arXiv:2404.06395; hf].  36 heads do not divide the model axis (16):
attention TP shards head_dim (64/16=4) instead — see distributed/sharding."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch="minicpm-2b", family="dense", n_layers=40, d_model=2304, n_heads=36,
    n_kv_heads=36, d_ff=5760, vocab=122753, head_dim=64, tie_embeddings=True,
)

SMOKE = ModelConfig(
    arch="minicpm-2b-smoke", family="dense", n_layers=2, d_model=72, n_heads=6,
    n_kv_heads=6, d_ff=180, vocab=256, head_dim=12, tie_embeddings=True,
    vocab_pad_multiple=64, dtype="float32",
)
