"""Public fused-norm entry point (the port of
``repro.kernels.fused_norm.ops``; no ``interpret`` flag: the device of
the tensors picks the kernel or its plain version)."""
from __future__ import annotations

import torch

from repro_torch.kernels.fused_norm import fused_norm as _kern


def fused_norm(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor | None = None,
    residual: torch.Tensor | None = None,
    *,
    eps: float = 1e-6,
    kind: str = "rms",
) -> torch.Tensor:
    """RMS/LayerNorm over the last axis in fp32 (+ residual, + bias)."""
    return _kern.fused_norm(x, weight, bias, residual, eps=eps, kind=kind)
