"""Public SSD entry points (the port of ``repro.kernels.ssd.ops``; no
``interpret`` flag: the device of the tensors picks the kernel or its plain
version)."""
from __future__ import annotations

import torch

from repro_torch.kernels.ssd import ssd as _kern
from repro_torch.kernels.ssd.ssd import ssd_decode_step  # noqa: F401 (re-export)


def ssd(
    x: torch.Tensor,     # (b, l, h, dh)
    dt: torch.Tensor,    # (b, l, h) fp32
    A: torch.Tensor,     # (h,) fp32
    B: torch.Tensor,     # (b, l, g, ds)
    C: torch.Tensor,     # (b, l, g, ds)
    D: torch.Tensor | None = None,           # (h,) fp32
    *,
    chunk: int = 128,
    init_state: torch.Tensor | None = None,  # (b, h, ds, dh) fp32
) -> tuple[torch.Tensor, torch.Tensor]:
    """(y, final_state) of the SSD scan from ``init_state`` (zeros if None)."""
    return _kern.ssd(x, dt, A, B, C, D, chunk=chunk, init_state=init_state)
