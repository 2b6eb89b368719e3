"""Public MoE grouped-GEMM entry point (the port of
``repro.kernels.moe_gmm.ops``; no ``interpret`` flag and no block sizes:
the device of the tensors picks the kernel or its plain version, and the
kernel masks ragged edges itself, so nothing is padded by copying)."""
from __future__ import annotations

import torch

from repro_torch.kernels.moe_gmm import moe_gmm as _kern


def grouped_matmul(
    x: torch.Tensor,                     # (e, c, k)
    w: torch.Tensor,                     # (e, k, n)
    counts: torch.Tensor | None = None,  # (e,) int32
    *,
    out_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """``y[e] = x[e] @ w[e]`` with an fp32 accumulator, rows at or past
    ``counts[e]`` exactly 0 (every row live when ``counts`` is None)."""
    return _kern.grouped_matmul(x, w, counts, out_dtype=out_dtype)
