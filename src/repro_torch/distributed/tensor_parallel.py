"""Tensor and expert parallel execution over a mesh's ``model`` axis.

The reference gets this from GSPMD: it places every parameter under
``sharding.params_shardings`` and XLA inserts the collectives.  Here each
rank holds its block of every leaf (``sharding.param_spec``) and the model
code calls the collectives itself, Megatron-style, through three autograd
functions over the ``model`` group:

* *copy to model* (:meth:`ModelParallel.copy`) where a tensor that is whole on every rank enters
  a split region (a column-split projection, a cross-attention source
  projected on this rank's heads, this rank's experts, a replicated
  weight used on this rank's heads only): identity forward,
  all-reduce of the gradient backward, since each rank's gradient covers
  only its part of the region;
* *reduce from model* (:meth:`ModelParallel.reduce`) where a split region's partial sums leave it
  (after the row-split ``wo`` and ``wd``, the experts' combine, the
  vocab-split embedding): all-reduce forward, identity backward;
* *gather from model* (:meth:`ModelParallel.gather`) where replicated code needs a split tensor
  whole (the router's logits, ``dh``-split q/k/v before RoPE, the
  VLM's vision tokens through the column-split ``vis_proj``, the
  logits): all-gather along a dimension forward, this rank's slice of the
  gradient backward.  The code after a gather is replicated, so its
  gradient is whole on every rank.

With a *copy* at every split region's entry, the gradient of a
replicated leaf (a norm weight, replicated K/V weights) is the same on
every model rank, and a split leaf's gradient is its block of the whole.

The Mamba-2 block (``models.mamba2``) keeps the rule's storage (its
``in_proj`` columns, conv channels and ``d_inner`` rows, each a
contiguous block, which do not line up with the z/x/B/C/dt parts) and
splits its compute by SSM heads: ``in_proj``'s block output and the conv
block's are each *gathered* whole and then enter the split region
through a *copy*, whose all-reduce backward makes their gradient whole
before the gather's backward takes this rank's slice; ``A_log``, ``D``,
``dt_bias`` (and a replicated conv) enter through a *copy* and are read
on this rank's heads; ``out_proj``'s row-split partial sums leave
through a *reduce*.  The gated RMSNorm's statistic over the whole
``d_inner`` is this rank's sum of squares through ``copy(reduce(s))``:
the *reduce* sums it forward, and since every rank's rows read the sum,
its gradient is partial on each rank and the *copy* sums it backward
(a *reduce* alone, identity backward, would drop the other ranks'
share).  Each backward path crosses exactly one all-reduce; two in a
row would multiply its gradient by the group's size.  Where ``d_inner``
does not divide, ``norm_w`` and ``out_proj`` stay whole and the block
after the gathers runs whole on every rank (every head, the whole norm,
``out_proj`` with no reduce): that code is replicated, so nothing in it
is copied, and only the split conv's input enters through a *copy*.

Every collective goes through ``distributed.collectives``: under gloo a
CUDA tensor is copied to the host and back, explicitly, and counted in
``collectives.STAGED``.  bf16 tensors go to gloo as bf16 (its all-reduce
and all-gather take them), so a bf16 model's partial sums are added in
bf16 across the ranks.  :data:`CLOCK` times the collectives when it is
switched on: each then synchronises the device before and after, so the
host time it adds is the collective's own.
"""
from __future__ import annotations

import time

import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import collectives
from repro_torch.distributed import sharding as sh
from repro_torch.launch.mesh import axis_sizes

# Host seconds spent in the model-axis collectives while ``on``.
CLOCK = {"on": False, "seconds": 0.0}


def _sync(t: torch.Tensor) -> None:
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


def _timed(fn, t: torch.Tensor, *args):
    if not CLOCK["on"]:
        return fn(t, *args)
    _sync(t)
    t0 = time.perf_counter()
    out = fn(t, *args)
    _sync(out)
    CLOCK["seconds"] += time.perf_counter() - t0
    return out


def _all_reduce(t: torch.Tensor, group, op=dist.ReduceOp.SUM):
    return collectives.all_reduce(t.contiguous().clone(), op=op, group=group)


def _all_gather(t: torch.Tensor, group, dim: int):
    return torch.cat(collectives.all_gather(t, group), dim=dim)


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _timed(_all_reduce, grad, ctx.group), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _timed(_all_reduce, x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim, rank):
        ctx.dim, ctx.rank, ctx.n = dim, rank, x.shape[dim]
        return _timed(_all_gather, x, group, dim)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(ctx.dim, ctx.rank * ctx.n, ctx.n), None, None, None


class ModelParallel:
    """This rank's place on the ``model`` axis of a ``(data, model)`` mesh
    and the sharding rule's picks for ``cfg``, computed locally from the
    config and the mesh's shape.

    ``q_split``/``kv_split`` name how attention splits (``"heads"``,
    ``"dh"`` or None for replicated), the rule's ``_attn_dims`` and
    ``_kv_dims``.  The model code reads local head, ``d_ff``, vocab and
    expert counts from its leaves' shapes; this object gives the group,
    this rank's index and the collectives."""

    def __init__(self, cfg: ModelConfig, mesh):
        self.cfg, self.mesh = cfg, mesh
        self.size = axis_sizes(mesh)["model"]
        self.rank = mesh.get_local_rank("model")
        self.group = mesh.get_group("model")
        qh, qd = sh._attn_dims(cfg, cfg.n_heads, self.size)
        kh, kd = sh._kv_dims(cfg, self.size)
        self.q_split = "heads" if qh else "dh" if qd else None
        self.kv_split = "heads" if kh else "dh" if kd else None
        if cfg.ssm_state:
            self._ssm_picks(cfg)

    def _ssm_picks(self, cfg: ModelConfig) -> None:
        """The Mamba-2 block's picks, read from the rule itself: whether
        ``in_proj``'s columns, the conv channels and ``d_inner``
        (``norm_w``, ``out_proj``'s rows) split over ``model`` (else each
        is replicated), and whether the SSM runs this rank's heads
        (``ssm_heads`` divides) or every head.  ``ssm_heads`` dividing
        makes ``d_inner`` divide, so split heads always have split rows."""
        di, g, ds = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state

        def split(leaf: str, shape: tuple) -> bool:
            spec = sh.param_spec(f"layers/mamba/{leaf}", shape, cfg,
                                 self.mesh)
            return "model" in spec

        self.in_proj_split = split(
            "in_proj", (cfg.d_model, 2 * di + 2 * g * ds + cfg.ssm_heads))
        self.conv_split = split("conv_w", (cfg.ssm_conv, di + 2 * g * ds))
        self.ssm_rows_split = split("norm_w", (di,))
        self.ssm_heads_split = cfg.ssm_heads % self.size == 0

    # -- the collectives ---------------------------------------------------

    def copy(self, x: torch.Tensor) -> torch.Tensor:
        return _Copy.apply(x, self.group)

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        return _Reduce.apply(x, self.group)

    def gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        return _Gather.apply(x, self.group, dim % x.dim(), self.rank)

    def all_reduce_(self, t: torch.Tensor, op=dist.ReduceOp.SUM):
        """``t`` reduced over the group in place, outside autograd (the
        vocab-parallel loss's statistics, the gradient norm)."""
        return _timed(lambda x: collectives.all_reduce(x, op=op,
                                                       group=self.group), t)

    # -- placement ---------------------------------------------------------

    def place(self, path: tuple, lead: tuple = ()):
        """``place(key, full) -> this rank's block`` for the leaves under
        ``path`` (list lengths ``lead`` above them, the axes the reference
        stacks): the leaf cut by its ``param_spec`` as it is drawn, and
        copied out (a block along the first dimension is a contiguous view
        that would keep the whole leaf's storage alive)."""
        def cut(key: str, full: torch.Tensor) -> torch.Tensor:
            spec = sh._leaf_spec(path + (key,), lead, tuple(full.shape),
                                 self.cfg, self.mesh, False)
            out = sh.shard(full, sh.Sharding(self.mesh, spec))
            return out if out is full else out.clone()
        return cut

    def kv_heads(self, hq_local: int) -> torch.Tensor | slice:
        """The replicated K/V heads this rank's query heads read: global
        query head j reads KV head ``j // (hq // hkv)``.  A slice where the
        local heads map onto a contiguous range in order (the attention
        then runs at the group ``hq_local // len``), else one KV head a
        query head (group 1)."""
        return self._read(self.cfg.n_heads, self.cfg.n_kv_heads, hq_local)

    def ssm_groups(self, h_local: int) -> torch.Tensor | slice:
        """The B/C groups this rank's SSM heads read (head j reads group
        ``j // (ssm_heads / ssm_groups)``), as :meth:`kv_heads`."""
        return self._read(self.cfg.ssm_heads, self.cfg.ssm_groups, h_local)

    def _read(self, n: int, n_read: int, local: int) -> torch.Tensor | slice:
        g = n // n_read
        first = self.rank * local
        want = [(first + i) // g for i in range(local)]
        lo, k = want[0], want[-1] - want[0] + 1
        if local % k == 0 and all(
                w - lo == i // (local // k) for i, w in enumerate(want)):
            return slice(lo, lo + k)
        return torch.tensor(want)


def model_parallel(cfg: ModelConfig, mesh) -> ModelParallel | None:
    """The context for ``mesh``'s ``model`` axis, None when it has one
    rank (or there is no mesh)."""
    if mesh is None or axis_sizes(mesh).get("model", 1) == 1:
        return None
    return ModelParallel(cfg, mesh)
