"""Plain-torch oracle for fused (RMS/Layer)Norm + optional residual add
(the twin of ``repro.kernels.fused_norm.ref``)."""
from __future__ import annotations

import torch


def fused_norm(
    x: torch.Tensor,                   # (..., d)
    weight: torch.Tensor,              # (d,)
    bias: torch.Tensor | None = None,  # (d,) -> LayerNorm-style shift
    residual: torch.Tensor | None = None,
    eps: float = 1e-6,
    kind: str = "rms",                 # "rms" | "layer"
) -> torch.Tensor:
    h = x.float()
    if residual is not None:
        h = h + residual.float()
    if kind == "layer":
        mu = h.mean(dim=-1, keepdim=True)
        var = (h - mu).square().mean(dim=-1, keepdim=True)
        y = (h - mu) / torch.sqrt(var + eps)
    else:
        ms = h.square().mean(dim=-1, keepdim=True)
        y = h / torch.sqrt(ms + eps)
    y = y * weight.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)
