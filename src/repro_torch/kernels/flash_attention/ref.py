"""Plain-torch oracle for causal GQA flash attention (the twin of
``repro.kernels.flash_attention.ref``)."""
from __future__ import annotations

import torch


def attention(
    q: torch.Tensor,  # (b, hq, sq, d)
    k: torch.Tensor,  # (b, hkv, skv, d)
    v: torch.Tensor,  # (b, hkv, skv, d)
    causal: bool = True,
    scale: float | None = None,
    q_offset: int = 0,
) -> torch.Tensor:
    b, hq, sq, d = q.shape
    _, hkv, skv, _ = k.shape
    group = hq // hkv
    scale = scale if scale is not None else d ** -0.5
    kx = k.repeat_interleave(group, dim=1).float()
    vx = v.repeat_interleave(group, dim=1).float()
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kx) * scale
    if causal:
        qi = torch.arange(sq, device=q.device)[:, None] + q_offset
        ki = torch.arange(skv, device=q.device)[None, :]
        s = s.masked_fill(ki > qi, float("-inf"))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    return torch.einsum("bhqk,bhkd->bhqd", p, vx).to(q.dtype)
