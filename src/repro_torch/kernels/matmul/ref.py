"""Plain-torch oracle for the policy-planned matmul (the twin of
``repro.kernels.matmul.ref``): an fp32 product cast to ``out_dtype``."""
from __future__ import annotations

import torch


def matmul(a: torch.Tensor, b: torch.Tensor,
           out_dtype: torch.dtype | None = None) -> torch.Tensor:
    out_dtype = out_dtype or a.dtype
    return (a.float() @ b.float()).to(out_dtype)
