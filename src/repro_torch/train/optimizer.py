"""AdamW with mixed precision and schedules (cosine / WSD / const), the port
of ``repro.train.optimizer``.

State is ``{"mu", "nu", "count"}`` with fp32 master moments in the
parameters' tree structure and an int32 step count; parameters may be
bf16: each update is computed in fp32 and cast back to the parameter's
dtype.  Unlike the reference's functional update, :func:`apply_updates`
writes the parameters, the moments and the count in place (under
``torch.no_grad()``), so a step holds no second copy of the state.
ZeRO-1 (``opt_shardings``) waits for the port's ``distributed/``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.utils import tree


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    schedule: str = "cosine"        # "cosine" | "wsd" | "const"
    decay_frac: float = 0.1         # WSD: final fraction of steps that decay
    min_lr_frac: float = 0.1


def schedule_lr(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Warmup + (cosine | warmup-stable-decay | const), in fp32 as the
    reference computes it."""
    stepf = torch.as_tensor(step).float()
    warm = torch.clamp(stepf / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp(
        (stepf - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps,
                                         1),
        0.0, 1.0,
    )
    if cfg.schedule == "cosine":
        frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
            1 + torch.cos(math.pi * t)
        )
    elif cfg.schedule == "wsd":
        # MiniCPM warmup-stable-decay: constant, then linear decay in the
        # final decay_frac of training.
        decay_start = 1.0 - cfg.decay_frac
        frac = torch.where(
            t < decay_start,
            1.0,
            1.0 - (1 - cfg.min_lr_frac) * (t - decay_start) / cfg.decay_frac,
        )
    else:
        frac = torch.ones_like(t)
    return cfg.lr * warm * frac


def init_state(params: Any) -> dict[str, Any]:
    """fp32 zero moments beside ``params`` and a zero int32 count."""
    dev = tree.leaves(params)[0].device
    return {
        "mu": tree.tree_zeros_like(params, torch.float32),
        "nu": tree.tree_zeros_like(params, torch.float32),
        "count": torch.zeros((), dtype=torch.int32, device=dev),
    }


def global_norm(grads: list[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares over every leaf, in fp32.  Each leaf is
    squared from a transient fp32 copy, so a bf16 gradient tree is never
    held in fp32 whole."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in grads))


def decay_mask(params: Any) -> list[bool]:
    """Which leaves (in ``tree.leaves_with_paths`` order) take weight decay.

    The reference decays every leaf with ``p.ndim >= 2`` in ITS layout,
    where the layers are stacked by ``vmap``: a layer's norm weight is
    (L, d) there and decayed, only top-level vectors (``ln_f``,
    ``ln_enc``, zamba2's unstacked ``shared`` norms) are not.  The port
    keeps layers as lists, so a leaf's rank in the reference layout is its
    own plus one for each list index on its path."""
    return [p.dim() + tree.stacked_axes(path) >= 2
            for path, p in tree.leaves_with_paths(params)]


@torch.no_grad()
def apply_updates(
    params: Any, grads: list[torch.Tensor], state: dict[str, Any],
    cfg: AdamWConfig,
) -> dict[str, torch.Tensor]:
    """One AdamW step, in place: ``grads`` is the list of gradients in
    ``tree.leaves(params)`` order (any float dtype; each is read through a
    transient fp32 copy).  Returns ``{"lr", "grad_norm"}``."""
    state["count"].add_(1)
    count = state["count"]
    lr = schedule_lr(cfg, count)
    gnorm = global_norm(grads)
    clip = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12),
                       max=1.0)
    countf = count.float()
    bc1 = 1 - torch.pow(cfg.b1, countf)
    bc2 = 1 - torch.pow(cfg.b2, countf)
    flat_p = tree.leaves(params)
    if len(grads) != len(flat_p):
        raise ValueError(f"apply_updates: {len(grads)} grads for "
                         f"{len(flat_p)} parameters")
    for p, g, mu, nu, decay in zip(flat_p, grads, tree.leaves(state["mu"]),
                                   tree.leaves(state["nu"]),
                                   decay_mask(params)):
        g = g.float() * clip
        mu.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        nu.mul_(cfg.b2).add_((1 - cfg.b2) * torch.square(g))
        del g
        step = (mu / bc1) / (torch.sqrt(nu / bc2) + cfg.eps)
        p32 = p.float()
        if decay:   # decoupled weight decay on (reference-layout) matrices
            step = step + cfg.weight_decay * p32
        p.copy_(p32 - lr * step)
    return {"lr": lr, "grad_norm": gnorm}
