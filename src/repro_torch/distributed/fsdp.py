"""FSDP (ZeRO-3) execution over a mesh's ``data`` axis: weights gathered
on use, gradients reduce-scattered.

The reference gets this from GSPMD: ``params_shardings(..., fsdp=True)``
puts ``data`` on each large leaf's largest free dimension
(``sharding._add_fsdp``), and XLA inserts the per-layer all-gathers and
the reduce-scattered gradients.  Here each rank holds its ``(model,
data)`` block of every leaf under that rule, and the model code gathers
a subtree's leaves over ``data`` where it uses them, through one autograd
function:

* forward: all-gather this rank's block along the leaf's ``data``
  dimension, giving the rank's ``model`` block, the leaf the
  tensor-parallel code (``distributed.tensor_parallel``) reads;
* backward: reduce-scatter the gradient along that dimension, so each
  rank gets its own block's gradient summed over the ``data`` ranks.

Only the leaves whose spec names ``data`` (on an axis of more than one
rank) are gathered; the others are passed through, whole over ``data``,
and reduced by the trainer as without FSDP.  The model code gathers a
layer's leaves inside the activation policy's region (``core.remat``),
so under ``SAVE_DOTS`` or ``RECOMPUTE`` the gathered weights are made
again by a second all-gather in the backward and not kept from forward
to backward; a top-level leaf (the embedding, ``vis_proj``, ``ln_f``) is
gathered at each use and dropped after it.

The gathers and reduce-scatters go through ``distributed.collectives``
(recorded for the dry run, staged through the host under gloo) and are
clocked by ``tensor_parallel.CLOCK`` with the ``model`` axis's.  A
gradient is reduce-scattered in the trainer's ``grad_reduce_dtype`` and
handed back in the leaf's dtype.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import collectives
from repro_torch.distributed import sharding as sh
from repro_torch.distributed.tensor_parallel import _timed
from repro_torch.launch.mesh import axis_sizes
from repro_torch.utils import tree


def _gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    return torch.cat(collectives.all_gather(x, group), dim=dim)


def _scatter(g: torch.Tensor, group, dim: int, dtype) -> torch.Tensor:
    out = collectives.reduce_scatter(g.movedim(dim, 0).to(dtype), group)
    return out.movedim(0, dim).contiguous().to(g.dtype)


class _GatherData(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim, dtype):
        ctx.group, ctx.dim, ctx.dtype = group, dim, dtype
        return _timed(_gather, x, group, dim)

    @staticmethod
    def backward(ctx, grad):
        return (_timed(_scatter, grad, ctx.group, ctx.dim, ctx.dtype), None,
                None, None)


def data_dim(spec: sh.Spec, sizes: dict[str, int]) -> int | None:
    """The dimension a spec splits over ``data`` (None if it does not, or
    ``data`` has one rank)."""
    if sizes.get("data", 1) == 1:
        return None
    return next((i for i, part in enumerate(spec)
                 if "data" in sh.spec_axes(part)), None)


class DataShards:
    """The ``data`` group of a ``(data, model)`` or ``(pod, data, model)``
    mesh and the FSDP rule's picks for ``cfg``: ``dims``, beside the
    parameter tree, the dimension each leaf splits over ``data`` (None
    for a leaf held whole over ``data``), from
    ``sharding.params_shardings(..., fsdp=True)`` on the config's whole
    shapes.  A mesh whose ``data`` axis has one rank splits nothing.
    ``reduce_dtype``: the dtype the gradients are reduce-scattered in
    (the trainer's ``grad_reduce_dtype``)."""

    def __init__(self, cfg: ModelConfig, mesh,
                 reduce_dtype: torch.dtype = torch.float32):
        from repro_torch.models.registry import param_shapes

        self.cfg, self.mesh = cfg, mesh
        self.group = mesh.get_group("data")
        self.reduce_dtype = reduce_dtype
        sizes = axis_sizes(mesh)
        shs = sh.params_shardings(param_shapes(cfg), cfg, mesh, fsdp=True)
        self.dims = tree.tree_map(lambda s: data_dim(s.spec, sizes), shs)

    def split_flags(self) -> list[bool]:
        """Which leaves (``tree.leaves`` order) are split over ``data``."""
        return [d is not None for d in tree.leaves(self.dims)]

    def place(self, path: tuple, lead: tuple = ()):
        """``place(key, full) -> this rank's block`` under the FSDP rule
        (``sharding.placer``), for the model's ``init``."""
        return sh.placer(self.cfg, self.mesh, path, lead, fsdp=True)

    def gather(self, sub: Any, path: tuple) -> Any:
        """``sub``, the parameters' subtree at ``path``, with each leaf
        split over ``data`` gathered whole over it (the rank's ``model``
        block), differentiably; the other leaves as they are."""
        dims = self.dims
        for key in path:
            dims = dims[key]
        return tree.tree_map(
            lambda x, d: x if d is None else _GatherData.apply(
                x, self.group, d, self.reduce_dtype), sub, dims)


def gather(fs: DataShards | None, sub: Any, *path) -> Any:
    """The subtree ``sub`` at ``path`` ready to use: gathered over
    ``data`` under FSDP (``fs``), ``sub`` itself without."""
    return sub if fs is None else fs.gather(sub, path)
