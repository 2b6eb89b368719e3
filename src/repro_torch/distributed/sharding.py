"""Sharding rules: map every param/activation/cache tensor onto the mesh
(the port of ``repro.distributed.sharding``).

Mesh axes: ``(data, model)`` single-pod, ``(pod, data, model)`` multi-pod.
``pod`` is outer data parallelism (gradient all-reduce crosses pods).

Tensor-parallel policy (DESIGN.md §5):
* attention: shard heads over ``model`` when divisible (most archs);
  minicpm (36H) / whisper (12H) shard head_dim instead (contraction
  sharding).  K/V weights with few KV heads (GQA kv<16) are replicated —
  they are small — while the decode KV *cache* is sharded over ``model``
  along the sequence dim (distributed flash-decode; partial-softmax
  collectives), which is also how long_500k shards over ``data``.
* MLP: d_ff over ``model``; vocab (padded) over ``model``; MoE experts over
  ``model`` (EP); Mamba d_inner projections over ``model``.

A spec is a tuple with one entry a dimension: ``None`` (replicated), an
axis name, or a tuple of axis names (the dimension split over their
product, the first one major), the reference's ``PartitionSpec`` as a
plain tuple.  The rules read a mesh only through
``launch.mesh.axis_sizes``, so a shape-only ``MeshShape`` serves as well
as a ``DeviceMesh``.

**Stacked and unstacked layers.**  The reference stacks layers on leading
axes (``layers/attn/wq`` is (L, d, hq, dh)); the port keeps per-layer
lists (``layers/3/attn/wq`` is (d, hq, dh)).  :func:`param_spec` is the
reference's rule, a pure function of ``(path, shape, cfg, mesh)``.
:func:`params_shardings` evaluates it on each port leaf's stacked view
(the list lengths on its path prepended to its shape, the list indices
dropped from its path) and keeps the leaf's own dimensions, so the specs
equal the reference's with the stacked axes removed.  Where FSDP picks a
stacked axis, which a per-layer tensor does not have, the leaf takes
FSDP's rule on its own dimensions instead (mamba2's and zamba2's
``conv_w``: its width goes to ``model`` and the layer axis is the largest
free one left).

**Placement.**  :class:`Sharding` pairs a mesh with a spec (the
reference's ``NamedSharding``); :func:`shard` cuts this rank's block out
of a full tensor and :func:`unshard` gathers the blocks back over the
mesh's axis groups (``distributed.collectives.all_gather``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.launch.mesh import axis_sizes
from repro_torch.utils import tree

Spec = tuple


def batch_axes(mesh) -> tuple[str, ...]:
    return ("pod", "data") if "pod" in axis_sizes(mesh) else ("data",)


def model_axis_size(mesh) -> int:
    return axis_sizes(mesh)["model"]


def _attn_dims(cfg: ModelConfig, n_heads: int, tp: int):
    """(head_spec, dh_spec) for a (…, heads, dh) QUERY/OUTPUT weight."""
    if n_heads % tp == 0:
        return "model", None
    if cfg.head_dim_ % tp == 0:
        return None, "model"
    return None, None


def _kv_dims(cfg: ModelConfig, tp: int):
    """(head_spec, dh_spec) for K/V weights — COUPLED to the Q rule.

    Mixing layouts (Q on heads, K/V on head_dim) makes the attention
    contraction unpartitionable.  So: shard kv heads when divisible;
    otherwise follow Q exactly — replicated K/V weights when Q is
    heads-sharded (GQA K/V is small), dh-sharded when Q is dh-sharded."""
    qh, qd = _attn_dims(cfg, cfg.n_heads, tp)
    if cfg.n_kv_heads % tp == 0:
        return "model", None
    if qh == "model":
        return None, None        # replicate: q heads-sharded, kv tiny
    return None, qd              # dh-sharded with q, or fully replicated


def spec(*parts) -> Spec:
    """A spec from its entries, normalised as ``PartitionSpec`` does: a
    one-axis tuple becomes the axis name, an empty one ``None``."""
    return tuple(None if p == () else p[0] if isinstance(p, tuple)
                 and len(p) == 1 else p for p in parts)


def spec_axes(part) -> tuple[str, ...]:
    """The mesh axes one spec entry names."""
    if part is None:
        return ()
    return (part,) if isinstance(part, str) else tuple(part)


def _add_fsdp(spec: Spec, shape: tuple[int, ...], mesh,
              min_bytes: int = 1 << 20) -> Spec:
    """ZeRO-3/FSDP: additionally shard a big parameter's largest free,
    data-divisible dim over `data` (weights all-gathered per layer in the
    forward, gradients reduce-scattered)."""
    if math.prod(shape) * 2 < min_bytes:
        return spec
    full = tuple(spec) + (None,) * (len(shape) - len(spec))
    used = {a for part in full for a in spec_axes(part)}
    if "data" in used:
        return spec
    data = axis_sizes(mesh)["data"]
    cands = [i for i, part in enumerate(full)
             if part is None and shape[i] % data == 0 and shape[i] >= data]
    if not cands:
        return spec
    i = max(cands, key=lambda j: shape[j])
    new = list(full)
    new[i] = "data"
    return tuple(new)


def param_spec(path: str, shape: tuple[int, ...], cfg: ModelConfig,
               mesh, fsdp: bool = False) -> Spec:
    """The spec of a parameter leaf (stacking dims auto-padded)."""
    tp = model_axis_size(mesh)
    d, f = cfg.d_model, cfg.d_ff
    dh = cfg.head_dim_

    def pad(rule: tuple) -> Spec:
        extra = len(shape) - len(rule)
        assert extra >= 0, (path, shape, rule)
        spec = (None,) * extra + tuple(rule)
        return _add_fsdp(spec, shape, mesh) if fsdp else spec

    qh, qd = _attn_dims(cfg, cfg.n_heads, tp)
    kh, kd = _kv_dims(cfg, tp)
    if ("wq" in path or path.endswith("bq")) and shape[-1] == dh:
        return pad((None, qh, qd) if "wq" in path else (qh, qd))
    if any(k in path for k in ("wk", "wv", "bk", "bv")) and shape[-1] == dh:
        rule = (None, kh, kd) if ("wk" in path or "wv" in path) else (kh, kd)
        return pad(rule)
    if "wo" in path and shape[-1] == d:
        return pad((qh, qd, None))
    if "router" in path:
        return pad((None, "model" if cfg.n_experts % tp == 0 else None))
    if any(k in path for k in ("wg", "wu")):
        if len(shape) >= 3 and shape[-3] == cfg.n_experts and shape[-2] == d:
            # EP: experts over model (d_ff stays local per expert shard).
            return pad(("model" if cfg.n_experts % tp == 0 else None, None,
                        None))
        return pad((None, "model" if f % tp == 0 else None))
    if "wd" in path:
        if len(shape) >= 3 and shape[-3] == cfg.n_experts and shape[-1] == d:
            return pad(("model" if cfg.n_experts % tp == 0 else None, None,
                        None))
        return pad(("model" if f % tp == 0 else None, None))
    if "tok" in path or "unembed" in path:
        v = cfg.padded_vocab
        if "unembed" in path:
            return pad((None, "model" if v % tp == 0 else None))
        return pad(("model" if v % tp == 0 else None, None))
    if "in_proj" in path:
        return pad((None, "model" if shape[-1] % tp == 0 else None))
    if "out_proj" in path:
        return pad(("model" if shape[-2] % tp == 0 else None, None))
    if "conv_w" in path:
        return pad((None, "model" if shape[-1] % tp == 0 else None))
    if "conv_b" in path or "norm_w" in path:
        return pad(("model" if shape[-1] % tp == 0 else None,))
    if "vis_proj" in path:
        return pad((None, "model" if d % tp == 0 else None))
    # norms, biases, A_log, D, dt_bias, dec_pos: replicated.
    return pad(())


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A spec on a mesh: where each block of a tensor lives."""
    mesh: Any
    spec: Spec


def _stacked_leaves(params: Any, path: tree.Path = (),
                    lead: tuple[int, ...] = ()):
    """Each leaf with its port path and the lengths of the lists above it
    (the axes the reference stacks), in ``tree.leaves_with_paths`` order."""
    if isinstance(params, dict):
        for key in sorted(params):
            yield from _stacked_leaves(params[key], path + (key,), lead)
    elif isinstance(params, (list, tuple)):
        for i, sub in enumerate(params):
            yield from _stacked_leaves(sub, path + (i,), lead + (len(params),))
    else:
        yield path, lead, params


def stacked_path(path: tree.Path) -> str:
    """A port leaf's path as the reference names the stacked leaf: the list
    indices dropped (``layers/3/attn/wq`` -> ``layers/attn/wq``)."""
    return "/".join(str(k) for k in path if not isinstance(k, int))


def _leaf_spec(path, lead, shape, cfg, mesh, fsdp) -> Spec:
    """The port leaf's spec: the stacked leaf's without its stacked axes,
    or, where FSDP chose a stacked axis, FSDP's rule on the leaf's own
    dims."""
    n = len(lead)
    full = param_spec(stacked_path(path), lead + tuple(shape), cfg, mesh,
                      fsdp=fsdp)
    full = tuple(full) + (None,) * (n + len(shape) - len(full))
    if any(spec_axes(p) for p in full[:n]):
        return _add_fsdp(full[n:], tuple(shape), mesh, min_bytes=0)
    return full[n:]


def params_shardings(params: Any, cfg: ModelConfig, mesh,
                     fsdp: bool = False) -> Any:
    """A tree of :class:`Sharding` beside the port's parameter tree (any
    leaves with a ``shape``)."""
    specs = {path: _leaf_spec(path, lead, leaf.shape, cfg, mesh, fsdp)
             for path, lead, leaf in _stacked_leaves(params)}
    return tree.tree_map_with_path(
        lambda path, _: Sharding(mesh, specs[path]), params)


def fsdp_needed(cfg: ModelConfig, mesh, train: bool,
                hbm_bytes: int = 16 * 1024**3) -> bool:
    """Napkin check: do params (+ fp32 optimizer state for training) fit a
    single TP shard without data-axis sharding?

    Serving uses a looser threshold: FSDP all-gathers per step are poison
    for decode latency — keep weights TP-resident unless they truly can't
    fit."""
    n = cfg.param_count()
    tp = model_axis_size(mesh)
    per_chip = n * 2 / tp            # bf16 params
    if train:
        per_chip += n * 12 / tp      # fp32 grads + mu + nu
        return per_chip > 0.35 * hbm_bytes
    return per_chip > 0.8 * hbm_bytes


def _batch_rule(mesh, global_batch: int):
    sizes = axis_sizes(mesh)
    ba = batch_axes(mesh)
    total = math.prod(sizes[a] for a in ba)
    if global_batch % total == 0:
        return ba
    if global_batch % sizes["data"] == 0:
        return ("data",)
    return None


def batch_spec(cfg: ModelConfig, mesh, global_batch: int) -> dict[str, Spec]:
    """Specs for a training/serving input batch."""
    b = _batch_rule(mesh, global_batch)
    return {
        "tokens": spec(b, None),
        "labels": spec(b, None),
        "vis": spec(b, None, None),
        "frames": spec(b, None, None),
    }


def cache_spec(cfg: ModelConfig, mesh, global_batch: int,
               long_context: bool = False):
    """``leaf_spec(path, x)`` for the serving cache's leaves (``path`` a
    string or a tree path, ``x`` anything with a ``shape``).

    Decode KV caches shard the sequence dim: over ``model`` normally, and
    over ``data`` too for long_context batch-1 (sequence parallelism — the
    distributed flash-decode schedule, ``distributed.sp_decode``)."""
    b = _batch_rule(mesh, global_batch)
    seq_axis = ("data",) if (long_context and b is None) else ("model",)
    tp = model_axis_size(mesh)

    kh, _ = _kv_dims(cfg, tp)

    def leaf_spec(path, x) -> Spec:
        p = path if isinstance(path, str) else tree.path_str(path)
        nd = len(x.shape)
        if p.endswith("/k") or p.endswith("/v") or "/k/" in p or "/v/" in p:
            if "cross" in p:
                # Fixed-source (enc/vision) KV: small, reused every step —
                # the RESIDENT operand; shard kv heads if divisible.
                return spec(*(None,) * (nd - 4), b, None, kh, None)
            # Self-attention cache (..., batch, S, hkv, dh): shard the
            # sequence dim — distributed flash-decode.  Long-context
            # batch-1 shards seq over `data` AND kv heads over `model`.
            head_axis = kh if long_context else None
            return spec(*(None,) * (nd - 4), b, seq_axis, head_axis, None)
        if "ssm" in p:
            # (L, batch, h, ds, dh): shard heads over model.
            return spec(*(None,) * (nd - 4), b,
                        "model" if cfg.ssm_heads % tp == 0 else None, None,
                        None)
        if "conv" in p:
            width = cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
            return spec(*(None,) * (nd - 3), b, None,
                        "model" if width % tp == 0 else None)
        if "vis" in p:
            return spec(*(None,) * (nd - 3), b, None, None)
        return (None,) * nd

    return leaf_spec


# ---------------------------------------------------------------------------
# Placement: this rank's block of a tensor, and the blocks gathered back
# ---------------------------------------------------------------------------

def _coordinates(mesh) -> dict[str, int]:
    """This rank's coordinate on each axis of a DeviceMesh."""
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError("this rank is not in the mesh")
    return dict(zip(mesh.mesh_dim_names, coord))


def _blocks(spec: Spec, ndim: int, sizes: dict[str, int]):
    """(dim, axes, count) for each sharded dimension of ``spec``."""
    full = tuple(spec) + (None,) * (ndim - len(spec))
    for dim, part in enumerate(full):
        axes = tuple(a for a in spec_axes(part) if sizes[a] > 1)
        if axes:
            yield dim, axes, math.prod(sizes[a] for a in axes)


def local_shape(shape, sh: Sharding) -> tuple[int, ...]:
    """The shape of one rank's block of a ``shape`` tensor."""
    out = list(shape)
    for dim, _, n in _blocks(sh.spec, len(shape), axis_sizes(sh.mesh)):
        if out[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(shape)} does not divide "
                             f"into {n} blocks ({sh.spec})")
        out[dim] //= n
    return tuple(out)


def shard(full: torch.Tensor, sh: Sharding) -> torch.Tensor:
    """This rank's block of ``full`` under ``sh`` (a view)."""
    sizes = axis_sizes(sh.mesh)
    blocks = list(_blocks(sh.spec, full.dim(), sizes))
    if not blocks:
        return full
    coord = _coordinates(sh.mesh)
    out = full
    for dim, axes, n in blocks:
        idx = 0
        for a in axes:              # the first axis major
            idx = idx * sizes[a] + coord[a]
        if full.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(full.shape)} does not "
                             f"divide into {n} blocks ({sh.spec})")
        step = full.shape[dim] // n
        out = out.narrow(dim, idx * step, step)
    return out


def unshard(local: torch.Tensor, sh: Sharding) -> torch.Tensor:
    """The full tensor from every rank's block (``local`` is this rank's):
    all-gathered over each sharded axis's group, the minor axis first."""
    from repro_torch.distributed.collectives import all_gather

    sizes = axis_sizes(sh.mesh)
    out = local
    for dim, axes, _ in reversed(list(_blocks(sh.spec, local.dim(), sizes))):
        for a in reversed(axes):
            parts = all_gather(out, sh.mesh.get_group(a))
            out = torch.cat(parts, dim=dim)
    return out


def shard_params(params: Any, cfg: ModelConfig, mesh,
                 fsdp: bool = False) -> Any:
    """This rank's block of every leaf of a whole parameter tree (e.g.
    ``convert.from_jax``'s or a one-process ``init``'s), leaf by leaf:
    each cut by its :func:`params_shardings` spec (``fsdp``: the FSDP
    rule's, ``data`` on the large leaves too) and copied out, so the
    whole leaf can be freed (a block along the first dimension is a
    contiguous view of the whole storage, which ``.contiguous()`` would
    keep)."""
    shs = params_shardings(params, cfg, mesh, fsdp=fsdp)

    def cut(p, s):
        out = shard(p, s)
        return out if out is p else out.clone()
    return tree.tree_map(cut, params, shs)


def placer(cfg: ModelConfig, mesh, path: tuple, lead: tuple = (),
           fsdp: bool = False):
    """``place(key, full) -> this rank's block`` for the leaves under
    ``path`` (list lengths ``lead`` above them, the axes the reference
    stacks): the leaf cut by its spec as it is drawn, and copied out (a
    block along the first dimension is a contiguous view that would keep
    the whole leaf's storage alive)."""
    def cut(key: str, full: torch.Tensor) -> torch.Tensor:
        spec = _leaf_spec(path + (key,), lead, tuple(full.shape), cfg, mesh,
                          fsdp)
        out = shard(full, Sharding(mesh, spec))
        return out if out is full else out.clone()
    return cut
