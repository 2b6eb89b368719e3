"""zamba2-2.7b: Mamba-2 backbone + shared attention block [arXiv:2411.15242].

Shared block applied every 6 SSM layers (9 invocations over 54 layers),
weights shared, KV caches per invocation."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch="zamba2-2.7b", family="hybrid", n_layers=54, d_model=2560, n_heads=32,
    n_kv_heads=32, d_ff=10240, vocab=32000, head_dim=80, ssm_state=64,
    ssm_headdim=64, ssm_groups=1, shared_attn_every=6, subquadratic=True,
)

SMOKE = ModelConfig(
    arch="zamba2-smoke", family="hybrid", n_layers=4, d_model=64, n_heads=4,
    n_kv_heads=4, d_ff=128, vocab=256, head_dim=16, ssm_state=16,
    ssm_headdim=16, ssm_groups=2, shared_attn_every=2, vocab_pad_multiple=64,
    dtype="float32", subquadratic=True,
)
