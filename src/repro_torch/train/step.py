"""Train-step builder: loss + grad + AdamW update (the port of
``repro.train.step``).

The activation (remat) policy is assigned by the cache-policy engine — the
paper's technique applied at the trainer level.  Gradients are reduced in a
configurable dtype when microbatched.

**The route.**  :func:`make_train_step` differentiates the plain route,
``decode_kernel="xla"``, whatever the config says, as the reference trains
on its XLA path: no Pallas kernel there has a VJP, and the port's CUDA
kernels are launched through ``ctypes`` into preallocated outputs, which
records no autograd graph (every kernel wrapper raises if asked to run on
a tensor that requires grad).  ``model.forward``/``model.loss`` called
directly keep honouring ``cfg.decode_kernel``.

**In place.**  The reference's step is functional; here ``train_step``
updates the state's parameters, moments and count in place and returns
the same dict.  With ``microbatch == 1`` the step's gradients stay in each
parameter's ``.grad`` (in the parameter's dtype) until the next step.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.remat import RematPolicy
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.train import optimizer as opt
from repro_torch.utils import tree


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    adamw: opt.AdamWConfig = dataclasses.field(default_factory=opt.AdamWConfig)
    remat: RematPolicy = RematPolicy.SAVE_DOTS
    microbatch: int = 1               # grad-accumulation splits per step
    grad_reduce_dtype: str = "float32"  # "bfloat16" halves collective bytes


def batch_to_device(batch: dict, device) -> dict[str, torch.Tensor]:
    """A step's batch (numpy arrays or tensors) as tensors on ``device``."""
    return {k: (torch.from_numpy(np.ascontiguousarray(v))
                if isinstance(v, np.ndarray) else v).to(device)
            for k, v in batch.items()}


def _reduce_dtype(g: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``g`` in the reduction dtype.  Widening bf16 to fp32 is exact, and
    the optimizer reads every gradient through a transient fp32 copy, so
    that cast is left to it (no fp32 copy of the whole gradient tree)."""
    if g.dtype == dtype or (dtype == torch.float32
                            and g.dtype in (torch.bfloat16, torch.float16)):
        return g
    return g.to(dtype)


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig, device=None):
    """Returns ``(train_step, model)``; ``train_step(state, batch) ->
    (state, metrics)`` with ``metrics`` {"loss", "ce", "aux", "lr",
    "grad_norm"} as 0-d tensors on the device."""
    # The plain route: see the module docstring.
    model = build_model(dataclasses.replace(cfg, decode_kernel="xla"),
                        device)
    device = resolve_device(device)
    reduce_dtype = getattr(torch, tcfg.grad_reduce_dtype)

    def train_step(state, batch):
        params = state["params"]
        leaves = tree.leaves(params)
        batch = batch_to_device(batch, device)
        for p in leaves:
            p.grad = None
        if tcfg.microbatch > 1:
            mb = tcfg.microbatch
            acc = [torch.zeros_like(p, dtype=reduce_dtype) for p in leaves]
            loss = torch.zeros((), dtype=torch.float32, device=device)
            for i in range(mb):
                part = {k: v.reshape(mb, v.shape[0] // mb, *v.shape[1:])[i]
                        for k, v in batch.items()}
                mloss, _ = model.loss(params, part, remat=tcfg.remat)
                grads = torch.autograd.grad(mloss, leaves)
                for a, g in zip(acc, grads):
                    a.add_(g.to(a.dtype))
                loss = loss + mloss.detach()
                del grads, mloss
            loss = loss / mb
            grads = [a / mb for a in acc]
            del acc
            metrics = {"ce": loss,
                       "aux": torch.zeros((), dtype=torch.float32,
                                          device=device)}
        else:
            loss, metrics = model.loss(params, batch, remat=tcfg.remat)
            loss.backward()
            loss = loss.detach()
            metrics = {k: v.detach() for k, v in metrics.items()}
            grads = [_reduce_dtype(p.grad, reduce_dtype) for p in leaves]
        stats = opt.apply_updates(params, grads, state["opt"], tcfg.adamw)
        return state, {"loss": loss, **metrics, **stats}

    return train_step, model


def init_train_state(model, generator: torch.Generator) -> dict[str, Any]:
    """Random parameters (requiring grad) and a fresh optimizer state."""
    params = model.init(generator)
    for p in tree.leaves(params):
        p.requires_grad_(True)
    return {"params": params, "opt": opt.init_state(params)}
