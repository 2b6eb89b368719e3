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

**Data parallel.**  Given a mesh whose batch axes (``TrainConfig.
batch_axes``: ``("data",)``, or ``("pod", "data")`` on a multi-pod mesh,
whose ranks are then flattened pod-major) have more than one rank, each
rank takes its rows of the global batch (rank r of n the r-th n-th), and
the gradients, cast to ``grad_reduce_dtype``, are summed over those ranks
through ``distributed.collectives.bucketed_all_reduce`` and divided by n.
Every rank holds the same number of rows and the loss is a mean over
tokens, so the mean of the ranks' losses and gradients is the global
batch's; the MoE load-balancing loss, which is not linear in the batch,
is given the ranks' mean of the per-expert fractions (the loss's
``density_mean``, see ``models.common._route``).  With
``zero1`` the optimizer state is this rank's block
(:func:`state_shardings`, ``optimizer.apply_updates``).

**Tensor and expert parallel.**  A mesh whose ``model`` axis has more
than one rank builds the model with it (``models.build_model(cfg, device,
mesh)``, every family): each rank holds its ``sharding.param_spec``
block of every leaf and the model code runs the ``model``-axis
collectives (``distributed.tensor_parallel``).  Batch rows (the tokens,
labels and whisper's frames or the VLM's vision tokens alike) split over
the batch axes only and are the same on every ``model`` rank; gradients
are reduced over the batch axes only, since a split leaf's gradient is
already this rank's block of the whole and a replicated leaf's the same
on every ``model`` rank.  The gradient norm that clips
the update is the whole model's (``optimizer.global_norm``: the squares
of split leaves summed over ``model``, replicated leaves counted once),
and ZeRO-1's moments are the ``data``-axis block of the rank's
``model``-axis block (``optimizer.opt_shardings``, the reference's rule:
replicated over ``pod``).

**FSDP** (``TrainConfig.fsdp``, ZeRO-3; the dense, MoE and VLM families).
The model is built with ``fsdp=True``: each rank holds its block of every
leaf under ``params_shardings(..., fsdp=True)`` (``data`` on the large
leaves' largest free dimension, beside ``model``), and the model code
gathers a layer's leaves over ``data`` where it uses them
(``distributed.fsdp``).  The gather's backward reduce-scatters the
gradient, so a data-split leaf's gradient comes out of the backward as
this rank's block, already summed over ``data``: it is divided by the
number of batch ranks and, with ``batch_axes`` ``("pod", "data")``,
all-reduced over ``pod``, never through the bucketed all-reduce (which
would multiply it by ``|data|``).  The other leaves are reduced as
without FSDP.  With ``microbatch > 1`` each microbatch gathers again
and the blocks accumulate.  The clip's norm sums a leaf's squares over
the groups of the axes its spec names (``model``, ``data`` or both), and
ZeRO-1's moments follow the parameter's block (``data`` being used,
the reference's ``opt_shardings`` adds nothing): :func:`moment_shardings`.
"""
from __future__ import annotations

import dataclasses
import functools
import math
import time
from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.remat import RematPolicy
from repro_torch.device import resolve_device
from repro_torch.distributed import collectives
from repro_torch.distributed import sharding as sh
from repro_torch.launch.mesh import axis_sizes
from repro_torch.models import build_model
from repro_torch.models.registry import param_shapes
from repro_torch.train import optimizer as opt
from repro_torch.utils import tree


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    adamw: opt.AdamWConfig = dataclasses.field(default_factory=opt.AdamWConfig)
    remat: RematPolicy = RematPolicy.SAVE_DOTS
    microbatch: int = 1               # grad-accumulation splits per step
    grad_reduce_dtype: str = "float32"  # "bfloat16" halves collective bytes
    zero1: bool = False
    # Mesh axes the batch dim shards over: ("data",), or ("pod", "data")
    # on a multi-pod mesh (the rows then split over the flattened pod x
    # data ranks); the rows are the same on every `model` rank.  Any other
    # value is refused.
    batch_axes: tuple = ("data",)
    # ZeRO-3: parameters split over `data` too, gathered on use, their
    # gradients reduce-scattered (the dry run's knob of the same name).
    fsdp: bool = False


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


class _DataParallel:
    """The data axis of a mesh as a train step sees it: this rank's rows of
    a global batch, and the gradient and metric reductions over the
    axis's group."""

    def __init__(self, cfg: ModelConfig, tcfg: TrainConfig, mesh,
                 fsdp_split=None):
        self.cfg, self.tcfg, self.mesh = cfg, tcfg, mesh
        self.n = _batch_ranks(tcfg, mesh)
        if len(tcfg.batch_axes) == 1:
            self.rank = mesh.get_local_rank("data")
            self.group = mesh.get_group("data")
            self.pod = None
        else:                   # ("pod", "data"): rank pod * |data| + data
            flat = mesh["pod", "data"]._flatten()
            self.rank = flat.get_local_rank()
            self.group = flat.get_group()
            self.pod = mesh.get_group("pod")
        # Under FSDP, which leaves (``tree.leaves`` order) are split over
        # ``data``: their gradients arrive summed over it.
        self.fsdp_split = fsdp_split
        # The moments' shardings, made here and not in the step: the rules
        # read the whole model's shapes (``param_shapes``), whose tensors
        # would count in a step's live bytes (``launch.dryrun``).
        self.moments = (moment_shardings(cfg, mesh, fsdp=tcfg.fsdp)
                        if tcfg.zero1 else None)
        self.last = {"payload_bytes": 0, "seconds": 0.0}

    def rows(self, batch: dict) -> dict:
        out = {}
        for k, v in batch.items():
            if v.shape[0] % self.n:
                raise ValueError(f"batch of {v.shape[0]} rows does not "
                                 f"split over {self.n} data ranks")
            per = v.shape[0] // self.n
            out[k] = v[self.rank * per:(self.rank + 1) * per]
        return out

    def mean(self, t: torch.Tensor) -> torch.Tensor:
        return collectives.all_reduce(t.detach().clone(), group=self.group
                                      ) / self.n

    def grads(self, grads: list[torch.Tensor]) -> list[torch.Tensor]:
        """The ranks' mean of each gradient.  A data-split leaf's (FSDP)
        is already summed over ``data`` by the gather's backward: only
        divided, and summed over ``pod`` where the batch spans it.
        ``self.last``: the bytes this rank put into the collectives
        (``payload_bytes``) and their host-clock ``seconds``."""
        t0 = time.perf_counter()
        split = self.fsdp_split or [False] * len(grads)
        out, sent = list(grads), 0
        for mine, group in ((False, self.group), (True, self.pod)):
            idx = [i for i, f in enumerate(split) if f == mine]
            if not idx:
                continue
            if group is None:   # data-split, no pod: summed already
                for i in idx:
                    out[i] = grads[i] / self.n
                continue
            part = [grads[i] for i in idx]
            for i, g in zip(idx, collectives.bucketed_all_reduce(part,
                                                                 group)):
                out[i] = g / self.n
            sent += sum(g.numel() * g.element_size() for g in part)
        self.last = {"payload_bytes": sent,
                     "seconds": time.perf_counter() - t0}
        return out


def _batch_ranks(tcfg: TrainConfig, mesh) -> int:
    """The ranks the batch rows split over: the product of the batch
    axes' sizes (1 without a mesh).  Refuses axes other than ``("data",)``
    and ``("pod", "data")``, and ``"pod"`` on a mesh without one."""
    axes = tuple(tcfg.batch_axes)
    if axes not in (("data",), ("pod", "data")):
        raise NotImplementedError(f"make_train_step: batch axes {axes}; "
                                  f"only ('data',) or ('pod', 'data')")
    if mesh is None:
        return 1
    sizes = axis_sizes(mesh)
    if any(a not in sizes for a in axes):
        raise ValueError(f"make_train_step: batch axes {axes} on a mesh of "
                         f"axes {tuple(sizes)}")
    return math.prod(sizes[a] for a in axes)


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig, device=None,
                    mesh=None):
    """Returns ``(train_step, model)``; ``train_step(state, batch) ->
    (state, metrics)`` with ``metrics`` {"loss", "ce", "aux", "lr",
    "grad_norm"} as 0-d tensors on the device.  ``mesh`` (a ``(data,
    model)`` DeviceMesh) makes it data parallel over ``data`` and tensor
    and expert parallel over ``model``: every rank passes the same global
    batch and a state from :func:`init_train_state` with the same
    ``mesh``, ``zero1`` and ``fsdp``."""
    # The plain route: see the module docstring.
    reduce_dtype = getattr(torch, tcfg.grad_reduce_dtype)
    model = build_model(dataclasses.replace(cfg, decode_kernel="xla"),
                        device, mesh, fsdp=tcfg.fsdp,
                        grad_reduce_dtype=reduce_dtype)
    device = resolve_device(device)
    dp = (_DataParallel(cfg, tcfg, mesh, model.data_shards
                        and model.data_shards.split_flags())
          if _batch_ranks(tcfg, mesh) > 1 else None)
    split = _norm_split(cfg, mesh, tcfg.fsdp)
    # The MoE aux loss reads the whole batch's per-expert fractions.
    moe = ({"density_mean": dp.mean}
           if dp is not None and cfg.n_experts else {})

    def train_step(state, batch):
        params = state["params"]
        leaves = tree.leaves(params)
        batch = batch_to_device(batch, device)
        if dp is not None:
            batch = dp.rows(batch)
            loss, grads, metrics = local_grads(params, leaves, batch)
            grads = dp.grads([g.to(reduce_dtype) for g in grads])
            loss = dp.mean(loss)
            metrics = {k: dp.mean(v) for k, v in metrics.items()}
            train_step.collective = dp.last
        else:
            loss, grads, metrics = local_grads(params, leaves, batch)
        stats = opt.apply_updates(
            params, grads, state["opt"], tcfg.adamw,
            shardings=dp.moments if dp else None, split=split)
        return state, {"loss": loss, **metrics, **stats}

    def local_grads(params, leaves, batch):
        for p in leaves:
            p.grad = None
        if tcfg.microbatch > 1:
            mb = tcfg.microbatch
            acc = [torch.zeros_like(p, dtype=reduce_dtype) for p in leaves]
            loss = torch.zeros((), dtype=torch.float32, device=device)
            for i in range(mb):
                part = {k: v.reshape(mb, v.shape[0] // mb, *v.shape[1:])[i]
                        for k, v in batch.items()}
                mloss, _ = model.loss(params, part, remat=tcfg.remat, **moe)
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
            loss, metrics = model.loss(params, batch, remat=tcfg.remat,
                                       **moe)
            loss.backward()
            loss = loss.detach()
            metrics = {k: v.detach() for k, v in metrics.items()}
            grads = [_reduce_dtype(p.grad, reduce_dtype) for p in leaves]
        return loss, grads, metrics

    train_step.collective = {"payload_bytes": 0, "seconds": 0.0}
    return train_step, model


def init_train_state(model, generator: torch.Generator, mesh=None,
                     zero1: bool = False) -> dict[str, Any]:
    """Random parameters (requiring grad) and a fresh optimizer state; with
    ``mesh`` and ``zero1`` the moments are this rank's blocks.  Every rank
    draws the same parameters from the same generator seed (a model built
    with a ``model > 1`` mesh or with FSDP keeps this rank's block of
    each)."""
    params = model.init(generator)
    for p in tree.leaves(params):
        p.requires_grad_(True)
    moments = (moment_shardings(model.config, mesh,
                                fsdp=model.data_shards is not None)
               if mesh is not None and zero1 else None)
    return {"params": params, "opt": opt.init_state(params, moments)}


def _norm_split(cfg: ModelConfig, mesh, fsdp: bool):
    """``(axes, groups)`` for ``optimizer.global_norm``: the axes of more
    than one rank among ``model`` and ``data`` (``data`` under FSDP) each
    leaf (``tree.leaves`` order) is split over, and their groups; None
    when no leaf is split."""
    if mesh is None:
        return None
    sizes = axis_sizes(mesh)
    over = [a for a in ("data", "model")
            if sizes.get(a, 1) > 1 and (a == "model" or fsdp)]
    if not over:
        return None
    axes = [tuple(a for a in over
                  if any(a in sh.spec_axes(part) for part in s.spec))
            for s in tree.leaves(state_shardings(cfg, mesh,
                                                 fsdp=fsdp)["params"])]
    return axes, {a: mesh.get_group(a) for a in over}


def moment_shardings(cfg: ModelConfig, mesh, fsdp: bool = False):
    """ZeRO-1's moments as the optimizer holds them: each moment's block
    (:func:`state_shardings`) of the parameter block this rank holds, its
    spec without the axes the parameter's names (``model``; under FSDP
    also ``data``, where the moment is then the parameter's own block)."""
    shs = state_shardings(cfg, mesh, zero1=True, fsdp=fsdp)

    def own(p: sh.Sharding, m: sh.Sharding) -> sh.Sharding:
        held = {a for part in p.spec for a in sh.spec_axes(part)} | {"model"}
        return sh.Sharding(m.mesh, sh.spec(*(
            tuple(a for a in sh.spec_axes(part) if a not in held)
            for part in m.spec)))
    return tree.tree_map(own, shs["params"], shs["opt"]["mu"])


def state_shardings(cfg: ModelConfig, mesh, params_shape=None,
                    zero1: bool = False, fsdp: bool = False
                    ) -> dict[str, Any]:
    """``{"params": ..., "opt": ...}`` trees of ``Sharding`` for a train
    state: each leaf's block of the whole model's (what a checkpoint
    gathers and restores).  ``params_shape["params"]`` is the parameter
    tree, or anything with its leaves' whole shapes; by default the
    config's (``models.registry.param_shapes``).  Under a ``model`` axis
    of more than one rank, or FSDP, a rank's own state holds blocks, so it
    is not accepted here.  ``fsdp``: the FSDP rule's parameter blocks
    (``params_shardings(..., fsdp=True)``) and the moments' beside them."""
    if params_shape is None:
        params_shape = {"params": param_shapes(cfg)}
    elif (axis_sizes(mesh).get("model", 1) > 1 or fsdp) and any(
            tuple(a.shape) != tuple(b.shape) for a, b in zip(
                tree.leaves(params_shape["params"]),
                tree.leaves(param_shapes(cfg)))):
        raise ValueError("state_shardings: the parameter tree holds blocks "
                         "of a model-parallel or FSDP rank; pass the whole "
                         "shapes (or none)")
    pshard = sh.params_shardings(params_shape["params"], cfg, mesh,
                                 fsdp=fsdp)
    oshard = opt.opt_shardings(pshard, params_shape["params"], mesh,
                               zero1=zero1)
    return {"params": pshard, "opt": oshard}


@functools.cache
def eval_shape_state(arch: str, smoke: bool = False):
    """``(cfg, model, state)``: a shape-only train state on ``"meta"``
    (nothing allocated) from :func:`init_train_state`, the one-process
    shapes, for the sharding rules and the dry run."""
    from repro_torch.models import get_config

    cfg = get_config(arch, smoke=smoke)
    model = build_model(cfg, "meta")
    return cfg, model, init_train_state(model, None)
