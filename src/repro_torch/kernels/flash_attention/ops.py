"""Public flash-attention entry points (the port of
``repro.kernels.flash_attention.ops``).

The reference's ``bq``/``bkv``/``engine`` block planning has no
counterpart yet: the CUDA kernel's tiles are fixed (64 query rows; 64 key
rows on the tensor-core body, 32 on the CUDA-core body).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import flash_attention as _kern


def flash_attention(
    q: torch.Tensor,          # (b, hq, sq, d)
    k: torch.Tensor,          # (b, hkv, skv, d)
    v: torch.Tensor,          # (b, hkv, skv, d)
    *,
    causal: bool = True,
    scale: float | None = None,
    q_offset=0,               # int or (b,) int32
    kv_len: torch.Tensor | None = None,   # (b,) int32
    q_len: torch.Tensor | None = None,    # (b,) int32
) -> torch.Tensor:
    """GQA flash attention over dense K/V."""
    return _kern.flash_attention(q, k, v, causal=causal, scale=scale,
                                 q_offset=q_offset, kv_len=kv_len,
                                 q_len=q_len)


def paged_flash_attention(
    q: torch.Tensor,          # (b, hq, sq, d)
    k_pool: torch.Tensor,     # (N, page_size, hkv, d)
    v_pool: torch.Tensor,     # (N, page_size, hkv, d)
    pages: torch.Tensor,      # (b, P) int32, -1 = unmapped
    *,
    causal: bool = True,
    scale: float | None = None,
    q_offset=0,
    kv_len: torch.Tensor | None = None,
    q_len: torch.Tensor | None = None,
) -> torch.Tensor:
    """GQA flash attention with K/V read in place from the page pool;
    bitwise equal to :func:`flash_attention` over the gathered view."""
    return _kern.paged_flash_attention(q, k_pool, v_pool, pages,
                                       causal=causal, scale=scale,
                                       q_offset=q_offset, kv_len=kv_len,
                                       q_len=q_len)
