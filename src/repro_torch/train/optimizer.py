"""AdamW with mixed precision and schedules (cosine / WSD / const), the port
of ``repro.train.optimizer``.

State is ``{"mu", "nu", "count"}`` with fp32 master moments in the
parameters' tree structure and an int32 step count; parameters may be
bf16: each update is computed in fp32 and cast back to the parameter's
dtype.  Unlike the reference's functional update, :func:`apply_updates`
writes the parameters, the moments and the count in place (under
``torch.no_grad()``), so a step holds no second copy of the state.

**ZeRO-1.**  :func:`opt_shardings` is the reference's rule: each moment
takes its parameter's spec with its first free dimension that ``|data|``
divides sharded over ``data``.  Where the reference expresses the sharded
update through shardings alone (GSPMD partitions the elementwise math),
the port does it by hand: given the moments' shardings,
:func:`init_state` holds only this rank's block of ``mu`` and ``nu``, and
:func:`apply_updates` updates that block of the moments and of the
parameter from the (all-reduced) gradient, then all-gathers the
parameter's blocks, so every rank ends with the same parameters, bitwise.
On the reference's stacked leaves the first free dimension is usually the
layer axis; on the port's per-layer leaves it is another one, with the
same 1/|data| of the bytes.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.distributed.sharding import (Sharding, local_shape, shard,
                                              spec_axes, unshard)
from repro_torch.launch.mesh import axis_sizes
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


def init_state(params: Any, shardings: Any = None) -> dict[str, Any]:
    """fp32 zero moments beside ``params`` and a zero int32 count; with
    ``shardings`` (a tree of the moments' :class:`Sharding`, as
    ``opt_shardings(...)["mu"]``) each moment is only this rank's block."""
    dev = tree.leaves(params)[0].device
    if shardings is None:
        mu = tree.tree_zeros_like(params, torch.float32)
        nu = tree.tree_zeros_like(params, torch.float32)
    else:
        def zeros(p, sh):
            return torch.zeros(local_shape(p.shape, sh), dtype=torch.float32,
                               device=p.device)
        mu = tree.tree_map(zeros, params, shardings)
        nu = tree.tree_map(zeros, params, shardings)
    return {"mu": mu, "nu": nu,
            "count": torch.zeros((), dtype=torch.int32, device=dev)}


def opt_shardings(param_shardings: Any, params_shape: Any, mesh,
                  zero1: bool = False) -> dict[str, Any]:
    """Shardings for the optimizer state (trees of :class:`Sharding`).

    ``zero1=True`` additionally shards each moment's first replicated,
    data-divisible dim over the data axis (ZeRO-1): memory/rank for mu/nu
    drops by |data|."""
    data_size = axis_sizes(mesh)["data"]

    def moment(s: Sharding, x) -> Sharding:
        if not zero1:
            return s
        shape = tuple(x.shape)
        spec = tuple(s.spec) + (None,) * (len(shape) - len(s.spec))
        if "data" in {a for part in spec for a in spec_axes(part)}:
            return s
        for i, part in enumerate(spec):
            if (part is None and shape[i] % data_size == 0
                    and shape[i] >= data_size):
                new = list(spec)
                new[i] = "data"
                return Sharding(s.mesh, tuple(new))
        return s

    mu = tree.tree_map(moment, param_shardings, params_shape)
    return {"mu": mu, "nu": mu, "count": Sharding(mesh, ())}


def global_norm(grads: list[torch.Tensor], split=None) -> torch.Tensor:
    """sqrt of the sum of squares over every leaf, in fp32.  Each leaf is
    squared from a transient fp32 copy, so a bf16 gradient tree is never
    held in fp32 whole.

    ``split`` ``(axes, groups)``: ``axes[i]`` the mesh axes leaf ``i`` is
    this rank's block over (a tuple of names, empty for a leaf whole on
    every rank: tensor parallel over ``model``, FSDP over ``data``, or
    both), ``groups`` each axis's process group.  The norm is then the
    whole model's: a split leaf's squares are summed over the groups of
    the axes it names and a replicated leaf counted once, so every rank
    clips alike."""
    def sq(gs):
        return sum((torch.sum(torch.square(g.float())) for g in gs),
                   torch.zeros((), device=grads[0].device))

    if split is None:
        return torch.sqrt(sq(grads))
    axes, groups = split
    from repro_torch.distributed.collectives import all_reduce

    total = sq(g for g, a in zip(grads, axes) if not a)
    for combo in sorted({tuple(a) for a in axes if a}):
        part = sq(g for g, a in zip(grads, axes) if tuple(a) == combo)
        for axis in combo:
            part = all_reduce(part, group=groups[axis])
        total = total + part
    return torch.sqrt(total)


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
    cfg: AdamWConfig, shardings: Any = None, split=None,
) -> dict[str, torch.Tensor]:
    """One AdamW step, in place: ``grads`` is the list of gradients in
    ``tree.leaves(params)`` order (any float dtype; each is read through a
    transient fp32 copy).  Returns ``{"lr", "grad_norm"}``.

    ``shardings`` (the moments' tree, as for :func:`init_state`) makes it
    the ZeRO-1 update: every rank passes the same full gradients, updates
    its block of the moments and the parameter, and the parameter's blocks
    are all-gathered back into each rank's full parameter.  A moment the
    size of its parameter (an FSDP leaf, already this rank's ``data``
    block) is updated whole, with no gather.  ``split``: see
    :func:`global_norm` (under tensor parallelism or FSDP a rank's
    "parameters" are its blocks, and the clip reads the whole model's
    norm)."""
    state["count"].add_(1)
    count = state["count"]
    lr = schedule_lr(cfg, count)
    gnorm = global_norm(grads, split)
    clip = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12),
                       max=1.0)
    countf = count.float()
    bc1 = 1 - torch.pow(cfg.b1, countf)
    bc2 = 1 - torch.pow(cfg.b2, countf)
    flat_p = tree.leaves(params)
    if len(grads) != len(flat_p):
        raise ValueError(f"apply_updates: {len(grads)} grads for "
                         f"{len(flat_p)} parameters")
    flat_sh = (tree.leaves(shardings) if shardings is not None
               else [None] * len(flat_p))
    for p, g, mu, nu, decay, sh in zip(flat_p, grads,
                                       tree.leaves(state["mu"]),
                                       tree.leaves(state["nu"]),
                                       decay_mask(params), flat_sh):
        blocked = sh is not None and tuple(mu.shape) != tuple(p.shape)
        if blocked:
            g, p_own = shard(g, sh), shard(p, sh)
        else:
            p_own = p
        g = g.float() * clip
        mu.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        nu.mul_(cfg.b2).add_((1 - cfg.b2) * torch.square(g))
        del g
        step = (mu / bc1) / (torch.sqrt(nu / bc2) + cfg.eps)
        p32 = p_own.float()
        if decay:   # decoupled weight decay on (reference-layout) matrices
            step = step + cfg.weight_decay * p32
        new = (p32 - lr * step).to(p.dtype)
        p.copy_(unshard(new, sh) if blocked else new)
    return {"lr": lr, "grad_norm": gnorm}
