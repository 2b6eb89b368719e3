"""Plain-torch oracle for the Mamba-2 SSD layer: the sequential state
recurrence (the twin of ``repro.kernels.ssd.ref``).

    S_t = exp(dt_t * A_h) * S_{t-1} + dt_t * outer(B_t, x_t)
    y_t = C_t @ S_t + D_h * x_t

with B/C shared across the heads of a group (n_groups <= n_heads).
"""
from __future__ import annotations

import torch


def ssd(
    x: torch.Tensor,    # (b, l, h, dh)
    dt: torch.Tensor,   # (b, l, h)      positive step sizes
    A: torch.Tensor,    # (h,)           negative decay rates
    B: torch.Tensor,    # (b, l, g, ds)
    C: torch.Tensor,    # (b, l, g, ds)
    D: torch.Tensor | None = None,           # (h,) skip
    init_state: torch.Tensor | None = None,  # (b, h, ds, dh)
) -> tuple[torch.Tensor, torch.Tensor]:
    b, l, h, dh = x.shape
    g, ds = B.shape[2], B.shape[3]
    hpg = h // g
    xf, dtf, Af = x.float(), dt.float(), A.float()
    Bf = B.float().repeat_interleave(hpg, dim=2)     # (b, l, h, ds)
    Cf = C.float().repeat_interleave(hpg, dim=2)
    S = (torch.zeros((b, h, ds, dh), dtype=torch.float32, device=x.device)
         if init_state is None else init_state.float())
    ys = []
    for t in range(l):
        decay = torch.exp(dtf[:, t] * Af[None, :])[..., None, None]
        S = S * decay + ((dtf[:, t, :, None] * Bf[:, t])[..., None]
                         * xf[:, t, :, None, :])
        ys.append(torch.einsum("bhs,bhsd->bhd", Cf[:, t], S))
    y = torch.stack(ys, dim=1)
    if D is not None:
        y = y + D[None, None, :, None] * xf
    return y.to(x.dtype), S
