"""Plain-torch oracle for single-token GQA decode attention (the twin of
``repro.kernels.decode_attention.ref``)."""
from __future__ import annotations

import torch


def decode_attention(
    q: torch.Tensor,        # (b, hq, d)
    k: torch.Tensor,        # (b, hkv, s, d)
    v: torch.Tensor,        # (b, hkv, s, d)
    lengths: torch.Tensor | None = None,  # (b,) valid KV lengths
    scale: float | None = None,
) -> torch.Tensor:
    b, hq, d = q.shape
    _, hkv, s, _ = k.shape
    group = hq // hkv
    scale = scale if scale is not None else d ** -0.5
    kx = k.repeat_interleave(group, dim=1).float()
    vx = v.repeat_interleave(group, dim=1).float()
    logits = torch.einsum("bhd,bhsd->bhs", q.float(), kx) * scale
    if lengths is not None:
        mask = (torch.arange(s, device=q.device)[None, None, :]
                < lengths.to(q.device)[:, None, None])
        logits = logits.masked_fill(~mask, float("-inf"))
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("bhs,bhsd->bhd", p, vx).to(q.dtype)
