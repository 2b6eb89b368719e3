"""Plain-torch oracle for the MoE grouped expert GEMM (capacity layout; the
twin of ``repro.kernels.moe_gmm.ref``)."""
from __future__ import annotations

import torch


def grouped_matmul(
    x: torch.Tensor,                     # (e, c, k) tokens gathered per expert
    w: torch.Tensor,                     # (e, k, n) expert weights
    counts: torch.Tensor | None = None,  # (e,) valid tokens per expert
    out_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    c = x.shape[1]
    out = torch.einsum("eck,ekn->ecn", x.float(), w.float())
    if counts is not None:
        rows = torch.arange(c, device=x.device)[None, :, None]
        out = torch.where(rows < counts.to(x.device)[:, None, None], out, 0.0)
    return out.to(out_dtype or x.dtype)
