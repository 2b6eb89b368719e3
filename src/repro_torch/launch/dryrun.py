"""Multi-pod dry run: build and run every (arch x shape x mesh) cell on meta
tensors over a 256- or 512-rank mesh (the port of ``repro.launch.dryrun``).

The reference jits each cell's step function under production shardings
over 512 forced host devices and reads XLA's compiled analyses.  The port
runs the real step instead, once, eagerly, on ``"meta"`` tensors (shapes
and dtypes, no storage): this process is rank 0 of a ``"fake"`` process
group of 256 (``16 x 16`` ``(data, model)``) or 512 (``2 x 16 x 16``
``(pod, data, model)``) ranks, whose collectives return at once.  The
model and state are built with the production shardings (each leaf this
rank's ``sharding.param_spec`` block, the cache its ``cache_spec`` block,
the optimizer moments their ZeRO-1 blocks), and ``train_step``,
``prefill`` or ``decode_step`` runs at full depth.  The record of a cell:

* ``cost_analysis``: ``flops`` from ``FlopCounterMode`` (matmul-class
  ops only: XLA's ``cost_analysis`` also counts elementwise work) and
  ``bytes accessed``, the input plus output bytes of every aten op that
  writes (a new storage, or an input in place); views and aliases count
  zero.  This is eager's unfused traffic, not XLA's fused count.
* ``memory_analysis``: ``argument_size_in_bytes`` is the rank's state
  (or parameters and cache) plus its inputs, worked out from
  ``sharding.local_shape`` under ``params_shardings``/``opt_shardings``/
  ``batch_spec`` and held against the meta tensors the run holds;
  ``temp_size_in_bytes`` is the peak of the live bytes of the storages
  the step makes; ``output_size_in_bytes`` the bytes of what it returns
  (``alias_size_in_bytes``: the part that is its arguments, updated in
  place).
* ``collectives_scanned_module_raw``: the collectives the step issued
  (``launch.roofline.collective_record``).
* ``counted``: the same counts under the reference's keys.  The
  reference extrapolates them from 1- and 2-unit lowers because XLA
  counts a scan body once; the eager run walks every layer, so they are
  the full-depth run's own (``units`` 1).
* ``roofline``: ``roofline.roofline_terms`` against ``hw.H100``.

``run_cell`` keeps the reference's rules, so the knobs equal the
reference's cell for cell: the auto-fit ladder, ``_fits`` at the
reference's 16 GiB, ``sharding.fsdp_needed`` at its default, and the
multi-pod cells' reuse of the single-pod knobs.  A train cell with FSDP
(the ``train_4k`` cells of yi-9b, granite-20b, qwen2.5-32b, phi3.5-moe,
olmoe-1b-7b and llama-3.2-vision-90b) builds its model and state under
``params_shardings(..., fsdp=True)`` and its step gathers each layer's
leaves over ``data`` and reduce-scatters their gradients
(``distributed.fsdp``): both appear in the collective record.  A cell
that waits on work the port has not done fails at once with
``NotImplementedError`` naming its ROADMAP item (:func:`waits_on`); it
never falls back to a one-rank run.

Usage:
    python -m repro_torch.launch.dryrun --arch yi-9b --shape decode_32k --mesh single
    python -m repro_torch.launch.dryrun --sweep            # all cells, subprocesses
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import subprocess
import sys
import time
import traceback
import weakref

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import hw
from repro_torch.configs.base import SHAPES
from repro_torch.core.remat import RematPolicy
from repro_torch.device import torch_dtype
from repro_torch.distributed import collectives
from repro_torch.distributed import sharding as sh
from repro_torch.launch import roofline
from repro_torch.launch.mesh import axis_sizes, make_production_mesh
from repro_torch.launch.specs import batch_specs, cache_shape
from repro_torch.models import build_model, get_config, runnable_cells
from repro_torch.models.registry import (FSDP_FAMILIES, FSDP_FAMILIES_ITEM,
                                         param_shapes)
from repro_torch.utils import tree

ARTIFACT_DIR = "artifacts/dryrun"


def plan_model_policies(cfg, shape, plan_cache=None,
                        chip: str = "h100") -> dict:
    """Plan cache policies for the model's per-layer op graph through the
    memoized policy engine (``repro_torch.core``) for ``chip`` (the
    reference plans for its default, ``"tpu-v5e"``).

    Characterizes each transformer layer's ops (norms, QKV/O projections,
    attention, MLP matmuls) as OpSpecs and plans all ``n_layers`` of them:
    every layer after the first hits the PlanCache, so the reported
    ``hit_rate`` is ~(L-1)/L per distinct op — the record's proof that
    repeated layers plan once.
    """
    from repro_torch.core import make_engine
    from repro_torch.core.characterize import (attention_op, matmul_op,
                                               rowwise_op)
    from repro_torch.core.planner import PlanCache

    eng = make_engine(chip=chip, plan_cache=plan_cache or PlanCache())
    b = max(1, shape.global_batch // hw.CHIPS_PER_POD)   # per-chip slice
    s = 1 if shape.kind == "decode" else shape.seq_len
    d, f = cfg.d_model, cfg.d_ff
    hq, hkv, dh = cfg.n_heads, max(1, cfg.n_kv_heads), cfg.head_dim_
    tokens = b * s
    layer_ops = [rowwise_op(tokens, d, passes=2, name="ln_in")]
    if hq and dh:
        layer_ops += [
            matmul_op(tokens, d, (hq + 2 * hkv) * dh, name="qkv_proj"),
            attention_op(b, hq, hkv, s, shape.seq_len, dh, name="attn"),
            matmul_op(tokens, hq * dh, d, name="o_proj"),
        ]
    if f:
        layer_ops += [
            rowwise_op(tokens, d, passes=2, name="ln_mlp"),
            matmul_op(tokens, d, f, name="mlp_up"),
            matmul_op(tokens, f, d, name="mlp_down"),
        ]
    policies = {}
    vmem_peak = 0
    for _ in range(max(1, cfg.n_layers)):
        for op in layer_ops:
            plan = eng.plan_op(op)
            eng.cost(op, plan)
            vmem_peak = max(vmem_peak, plan.vmem_bytes)
            policies[op.name] = {
                o.name: plan.assignment[o.name].value for o in op.operands
            }
    stats = eng.plan_stats()
    return {
        "layers": cfg.n_layers,
        "ops_per_layer": len(layer_ops),
        "ops_planned": max(1, cfg.n_layers) * len(layer_ops),
        "plan_cache_hit_rate": stats["hit_rate"],
        "plan_cache": stats,
        "vmem_peak_bytes": vmem_peak,
        "policies": policies,
    }


# ---------------------------------------------------------------------------
# The account of one eager step
# ---------------------------------------------------------------------------

def _key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def _nbytes(t: torch.Tensor) -> int:
    """A tensor's bytes read or written once (a broadcast view counts its
    storage, not its expanded size)."""
    return min(t.numel() * t.element_size(), t.untyped_storage().nbytes())


def _tensors(obj, out=None) -> list[torch.Tensor]:
    """The tensors in nested lists, tuples and dicts (an op's arguments and
    results), in order."""
    out = [] if out is None else out
    if isinstance(obj, torch.Tensor):
        out.append(obj)
    elif isinstance(obj, (list, tuple)):
        for x in obj:
            _tensors(x, out)
    elif isinstance(obj, dict):
        for x in obj.values():
            _tensors(x, out)
    return out


def unique_bytes(tensors) -> int:
    """The bytes of the distinct storages under ``tensors``."""
    seen = {}
    for t in tensors:
        seen.setdefault(_key(t), t.untyped_storage().nbytes())
    return sum(seen.values())


# In-place scatters touch only the rows they write: their destination
# counts zero and the other inputs (rows, indices) count twice, read and
# written.
_SCATTERS = {"index_put_", "_index_put_impl_", "index_add_", "index_copy_",
             "scatter_", "scatter_add_", "scatter_reduce_",
             "masked_scatter_"}


class _Traffic(TorchDispatchMode):
    """Every aten op's bytes (its inputs and outputs once each, for an op
    that writes: a new storage, or an input in place; an in-place scatter
    its rows, see ``_SCATTERS``; views and aliases count zero; the
    collectives' own ops are the roofline's collective term, not counted
    here), and the live bytes of the storages made inside, with their
    peak."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self._live: dict[int, int] = {}

    def _free(self, key: int) -> None:
        self.live -= self._live.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.namespace in ("c10d", "_c10d_functional"):
            return out
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        in_keys = {_key(t) for t in ins}
        new = [t for t in outs if _key(t) not in in_keys]
        if func._opname in _SCATTERS:
            self.bytes += 2 * sum(map(_nbytes, ins[1:]))
        elif new or any(a.alias_info is not None and a.alias_info.is_write
                        for a in func._schema.arguments):
            self.bytes += sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        for t in new:
            st = t.untyped_storage()
            key = st._cdata
            if key in self._live:
                continue
            self._live[key] = st.nbytes()
            self.live += self._live[key]
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, key)
        return out


def count_step(step, arguments) -> dict:
    """Run ``step()`` once under the counters; ``arguments`` are the
    tensors it reads that exist before it (state, inputs, cache).  The
    same function counts a meta run and a run on the card.  Returns
    ``{"cost": {"flops", "bytes accessed"}, "mem": {...}, "colls":
    collective record, "seconds"}``; ``mem`` holds the held bytes of the
    arguments (``argument_size_in_bytes``), the peak of the step's own
    live storages (``temp_size_in_bytes``) and the bytes of what it
    returns (``output_size_in_bytes``, ``alias_size_in_bytes``)."""
    from torch.utils.flop_counter import FlopCounterMode

    arg_keys = {_key(t) for t in arguments}
    t0 = time.perf_counter()
    with collectives.recording() as notes, \
            FlopCounterMode(display=False) as flops, _Traffic() as traffic:
        out = step()
    seconds = time.perf_counter() - t0
    outs = _tensors(out)
    return {
        "cost": {"flops": float(flops.get_total_flops()),
                 "bytes accessed": float(traffic.bytes)},
        "mem": {"argument_size_in_bytes": unique_bytes(arguments),
                "output_size_in_bytes": unique_bytes(outs),
                "temp_size_in_bytes": traffic.peak,
                "alias_size_in_bytes": unique_bytes(
                    [t for t in outs if _key(t) in arg_keys])},
        "colls": roofline.collective_record(notes),
        "seconds": seconds,
    }


# ---------------------------------------------------------------------------
# Building a cell
# ---------------------------------------------------------------------------

_MESHES: dict = {}


def production_mesh(multi_pod: bool):
    """The production ``DeviceMesh`` over a ``"fake"`` process group of
    256 or 512 ranks, this process rank 0 (the group is made on first use
    and is process-wide, so one process runs one world size)."""
    from torch.distributed.device_mesh import init_device_mesh

    shape = make_production_mesh(multi_pod=multi_pod)
    world = math.prod(shape.sizes)
    if not dist.is_initialized():
        from torch.testing._internal.distributed.fake_pg import FakeStore

        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=world)
    if dist.get_world_size() != world:
        raise RuntimeError(f"dry run: the process group has "
                           f"{dist.get_world_size()} ranks, the mesh "
                           f"{world}; run each world size in its own "
                           f"process")
    if shape not in _MESHES:
        _MESHES[shape] = init_device_mesh("cpu", shape.sizes,
                                          mesh_dim_names=shape.axis_names)
    return _MESHES[shape]


def waits_on(cfg, shape, fsdp: bool) -> str | None:
    """The ROADMAP item a cell waits on, None when the port runs it: a
    train cell asked for FSDP of a family without it (no cell at the
    rules' defaults)."""
    if fsdp and cfg.family not in FSDP_FAMILIES:
        return FSDP_FAMILIES_ITEM
    return None


def _block_bytes(shapes_and_shardings, dtype_of) -> int:
    return sum(math.prod(sh.local_shape(tuple(x.shape), s))
               * torch.empty((), dtype=dtype_of(x)).element_size()
               for x, s in shapes_and_shardings)


def _check(name: str, worked_out: int, held: int) -> int:
    if worked_out != held:
        raise AssertionError(f"dry run: the {name} blocks worked out from "
                             f"the shardings hold {worked_out} bytes, the "
                             f"rank's meta tensors {held}")
    return worked_out


def _state_parts(cfg, mesh, state, zero1: bool, fsdp: bool) -> dict:
    """The rank's parameter and optimizer bytes from ``local_shape`` under
    ``params_shardings``/``opt_shardings`` (``fsdp``: the FSDP rule's),
    held against ``state``."""
    from repro_torch.train.step import state_shardings

    whole = param_shapes(cfg)
    shs = state_shardings(cfg, mesh, zero1=zero1, fsdp=fsdp)
    pairs = list(zip(tree.leaves(whole), tree.leaves(shs["params"])))
    params = _block_bytes(pairs, lambda x: x.dtype)
    opt = 2 * _block_bytes(
        zip(tree.leaves(whole), tree.leaves(shs["opt"]["mu"])),
        lambda x: torch.float32) + state["opt"]["count"].element_size()
    return {"params": _check("parameter", params,
                             tree.tree_bytes(state["params"])),
            "opt": _check("optimizer", opt, tree.tree_bytes(state["opt"]))}


def _input_bytes(cfg, mesh, shape, batch: dict) -> int:
    bspec = sh.batch_spec(cfg, mesh, shape.global_batch)
    return _block_bytes(((x, sh.Sharding(mesh, bspec[k]))
                         for k, x in batch.items()), lambda x: x.dtype)


def build_cell(arch: str, shape_name: str, multi_pod: bool,
               remat: str = "save_dots", grad_reduce_dtype: str = "float32",
               microbatch: int = 1, zero1: bool = False, fsdp="auto",
               moe_dispatch: str = "dense", cfg=None, smoke: bool = False):
    """The cell on ``"meta"`` over the production mesh -> ``(cfg, shape,
    mesh, step, arguments, parts)``: ``step()`` runs the cell's step once,
    ``arguments`` are the tensors it reads, ``parts`` the rank's argument
    bytes by kind (worked out from the shardings).  Raises
    ``NotImplementedError`` before building anything for a cell that
    waits on another ROADMAP item."""
    from repro_torch.train.step import (TrainConfig, init_train_state,
                                        make_train_step)

    cfg = cfg or get_config(arch, smoke=smoke)
    if moe_dispatch != "dense":
        cfg = dataclasses.replace(cfg, moe_dispatch=moe_dispatch)
    shape = SHAPES[shape_name]
    rules_mesh = make_production_mesh(multi_pod=multi_pod)
    use_fsdp = (sh.fsdp_needed(cfg, rules_mesh, train=shape.kind == "train")
                if fsdp == "auto" else fsdp in (True, "on", "true"))
    item = waits_on(cfg, shape, use_fsdp)
    if item is not None:
        raise NotImplementedError(f"{cfg.arch} x {shape_name}: waits on "
                                  f"{item}")
    if use_fsdp and shape.kind != "train":
        raise NotImplementedError(
            f"{cfg.arch} x {shape_name}: FSDP is the trainer's; the serving "
            f"path holds its weights whole over 'data'")
    mesh = production_mesh(multi_pod)
    if shape.kind == "train":
        tcfg = TrainConfig(remat=RematPolicy(remat),
                           grad_reduce_dtype=grad_reduce_dtype,
                           microbatch=microbatch, zero1=zero1,
                           batch_axes=tuple(sh.batch_axes(mesh)),
                           fsdp=use_fsdp)
        train_step, model = make_train_step(cfg, tcfg, "meta", mesh)
        state = init_train_state(model, None, mesh, zero1=zero1)
        batch = batch_specs(cfg, shape)
        parts = {**_state_parts(cfg, mesh, state, zero1, use_fsdp),
                 "inputs": _input_bytes(cfg, mesh, shape, batch)}
        rows = train_step_rows(batch, mesh, tcfg)
        arguments = tree.leaves(state) + rows

        def step():
            return train_step(state, batch)
        return cfg, shape, mesh, step, arguments, parts
    long = shape_name == "long_500k"
    model = build_model(cfg, "meta", mesh, long_context=long)
    params = model.init(None)
    # The one-process cache on meta and the source it took (the global
    # batch's frames or vision tokens), as ``specs.cache_shape`` makes it.
    whole, source = cache_shape(build_model(cfg, "meta"), cfg,
                                shape.global_batch, shape.seq_len)
    cache = model.init_cache(params, batch=shape.global_batch,
                             max_len=shape.seq_len, **source)
    b = cache["lengths"].shape[0]
    s = shape.seq_len if shape.kind == "prefill" else 1
    tokens = torch.empty((b, s), dtype=torch.int32, device="meta")
    parts = {
        "params": _check("parameter", _block_bytes(
            zip(tree.leaves(param_shapes(cfg)),
                tree.leaves(sh.params_shardings(param_shapes(cfg), cfg,
                                                mesh))),
            lambda x: x.dtype), tree.tree_bytes(params)),
        **_cache_parts(cfg, mesh, shape.global_batch, long, whole, cache),
        "inputs": _check("input", _block_bytes(
            [(torch.empty((shape.global_batch, s), dtype=torch.int32,
                          device="meta"),
              sh.Sharding(mesh, sh.batch_spec(cfg, mesh,
                                              shape.global_batch)["tokens"]))],
            lambda x: x.dtype), tokens.numel() * 4),
    }
    entry = model.prefill if shape.kind == "prefill" else model.decode_step
    arguments = tree.leaves(params) + tree.leaves(cache) + [tokens]

    def step():
        return entry(params, cache, tokens)
    return cfg, shape, mesh, step, arguments, parts


def _self_kv(path: str) -> bool:
    """A self-attention K/V ring's leaf (it carries a sink position on its
    sequence dim, ``models.common``); the cross K/V carry none."""
    return (path.endswith("/k") or path.endswith("/v")) and "cross" not in path


def _cache_parts(cfg, mesh, batch: int, long_context: bool, whole,
                 cache) -> dict:
    """The rank's cache bytes by part: ``cache`` the ``cache_spec`` blocks
    of every leaf but the cursors, worked out from the one-process
    ``whole`` cache's shapes (the rings' sinks taken off) under
    ``sharding.local_shape`` and held leaf by leaf against the rank's
    ``cache``; ``cache_sink`` the rank's sink positions;
    ``cache_lengths`` its cursors (its rows; the reference's are
    replicated)."""
    spec_of = sh.cache_spec(cfg, mesh, batch, long_context=long_context)
    rank = dict((tree.path_str(p), x)
                for p, x in tree.leaves_with_paths(cache))
    blocks = sinks = 0
    for path, x in tree.leaves_with_paths(whole):
        p = tree.path_str(path)
        if p == "lengths":
            continue
        public, held = list(x.shape), list(rank[p].shape)
        if _self_kv(p):
            public[-3] -= 1
            held[-3] -= 1
            sinks += (math.prod(rank[p].shape) - math.prod(held)) * \
                rank[p].element_size()
        pub = torch.empty(public, device="meta")
        n = math.prod(sh.local_shape(tuple(public), sh.Sharding(
            mesh, spec_of(p, pub)))) * x.element_size()
        blocks += _check(f"cache {p}", n,
                         math.prod(held) * rank[p].element_size())
    return {"cache": blocks, "cache_sink": sinks,
            "cache_lengths": cache["lengths"].numel() * 4}


def train_step_rows(batch: dict, mesh, tcfg) -> list[torch.Tensor]:
    """The rank's rows of a global batch (what the step reads of it)."""
    n = math.prod(axis_sizes(mesh)[a] for a in tcfg.batch_axes)
    return [v[:v.shape[0] // n] for v in batch.values()]


def analyze(cfg, shape, mesh, counted: dict, parts: dict) -> dict:
    mem = dict(counted["mem"])
    # The rank's argument bytes as the shardings give them (the held
    # arguments count the whole global batch, the rank reads its rows).
    mem["argument_size_in_bytes"] = sum(parts.values())
    return {
        "arch": cfg.arch,
        "shape": shape.name,
        "mesh": axis_sizes(mesh),
        "n_chips": math.prod(axis_sizes(mesh).values()),
        "step_seconds": round(counted["seconds"], 2),
        "cost_analysis": counted["cost"],
        "memory_analysis": mem,
        "argument_parts": parts,
        "collectives_scanned_module_raw": counted["colls"],
    }


HBM_BYTES = 16 * 1024**3


def _fits(mem: dict) -> bool:
    need = mem.get("argument_size_in_bytes", 0) + mem.get("temp_size_in_bytes", 0)
    return bool(need and need <= HBM_BYTES)


def _prior_knobs(arch: str, shape_name: str, out_dir: str) -> dict | None:
    """Fitted knobs from the single-pod record (reused by multi-pod)."""
    path = os.path.join(out_dir, f"{arch}__{shape_name}__single.json")
    if os.path.exists(path):
        try:
            with open(path) as f:
                return json.load(f).get("knobs")
        except Exception:
            return None
    return None


def rank_rows(shape_name: str, multi_pod: bool) -> int:
    """A rank's rows of the cell's global batch (over the batch axes)."""
    mesh = make_production_mesh(multi_pod=multi_pod)
    sizes = axis_sizes(mesh)
    return SHAPES[shape_name].global_batch // math.prod(
        sizes[a] for a in sh.batch_axes(mesh))


def cell_knobs(arch: str, shape_name: str, multi_pod: bool, out_dir: str,
               tag: str = "", smoke: bool = False, **knobs) -> dict:
    """The reference's first-rung knobs of a cell: the multi-pod reuse of
    the single-pod record's, FSDP resolved at its default on the 16 x 16
    mesh, and the train cells' recompute/mb4 baseline.  A reused
    microbatch count is capped at the rank's rows: the single-pod cell's
    16 microbatches of 16 rows a rank leave a multi-pod rank's 8 rows
    none (the reference's GSPMD pads a 16-row microbatch over 32 ranks;
    a rank of the port holds whole rows)."""
    shape_kind = SHAPES[shape_name].kind
    if multi_pod and not tag:
        prior = _prior_knobs(arch, shape_name, out_dir)
        if prior:
            knobs = dict(knobs, **prior)
            if shape_kind == "train":
                knobs["microbatch"] = min(knobs.get("microbatch", 1),
                                          rank_rows(shape_name, True))
    if "fsdp" not in knobs or knobs["fsdp"] == "auto":
        knobs = dict(knobs, fsdp=sh.fsdp_needed(
            get_config(arch, smoke=smoke), make_production_mesh(),
            train=shape_kind == "train"))
    if shape_kind == "train" and knobs.get("remat") == "save_dots" and (
        knobs.get("microbatch", 1) == 1
    ):
        # Baseline train config: recompute/mb4 (the save_dots/mb1 rung never
        # fits the 4k-seq 16GB-HBM cells).
        knobs = dict(knobs, remat="recompute", microbatch=4)
    return knobs


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir: str,
             tag: str = "", auto_fit: bool = True, counting: bool = True,
             smoke: bool = False, **knobs) -> dict:
    """Run one cell.  ``auto_fit`` escalates (microbatch, remat) like the
    allocation-bypass planner does for residency: never 'OOM-stall',
    demote the activation-residency policy / split the batch until the
    cell fits HBM.  Multi-pod cells reuse the single-pod run's fitted
    knobs; ``counting`` False writes the reference's multi-pod record
    (memory and collective count, no roofline)."""
    shape_kind = SHAPES[shape_name].kind
    knobs = cell_knobs(arch, shape_name, multi_pod, out_dir, tag, smoke,
                       **knobs)
    ladder = [dict(knobs)]
    if auto_fit and shape_kind == "train":
        step_knobs = dict(knobs, remat="recompute", microbatch=min(
            max(16, knobs.get("microbatch", 1)),
            rank_rows(shape_name, multi_pod)))
        if step_knobs not in ladder:
            ladder.append(step_knobs)

    result = mem = counted = None
    t0 = t1 = time.perf_counter()
    for i, kn in enumerate(ladder):
        t0 = time.perf_counter()
        cfg, shape, mesh, step, arguments, parts = build_cell(
            arch, shape_name, multi_pod, smoke=smoke, **kn)
        t1 = time.perf_counter()
        counted = count_step(step, arguments)
        del step, arguments
        result = analyze(cfg, shape, mesh, counted, parts)
        mem = result["memory_analysis"]
        knobs = kn
        if not auto_fit or shape_kind != "train" or _fits(mem):
            break
        if i < len(ladder) - 1:
            print(f"[dryrun] {arch} x {shape_name}: "
                  f"temp={mem.get('temp_size_in_bytes', 0)/2**30:.1f}GiB "
                  f"does not fit; escalating to {ladder[i+1]}", flush=True)
    colls = counted["colls"]
    if counting:
        cost = counted["cost"]
        result["counted"] = {
            "flops": cost["flops"], "bytes": cost["bytes accessed"],
            "coll_moved": colls["total_moved_bytes"],
            "coll_count": colls["total_count"],
            "coll_per_kind": {k: v["moved_bytes"]
                              for k, v in colls["per_kind"].items()},
            "units": 1}
        result["roofline"] = roofline.roofline_terms(
            cfg, shape, mesh, cost, colls, mem, chip=hw.H100)
    else:
        result["counted"] = {"coll_count": colls["total_count"]}
        result["roofline"] = {
            "fits_hbm": _fits(mem) if mem else None,
            "hbm_need_bytes": mem.get("argument_size_in_bytes", 0)
            + mem.get("temp_size_in_bytes", 0),
            "note": "multi-pod memory proof; roofline from single-pod",
        }
    try:
        result["policy_plan"] = plan_model_policies(cfg, shape)
    except Exception as e:  # the report must never sink the run
        result["policy_plan"] = {"error": str(e)}
    result["build_seconds"] = round(t1 - t0, 2)
    result["knobs"] = knobs
    mesh_tag = "multi" if multi_pod else "single"
    os.makedirs(out_dir, exist_ok=True)
    fname = f"{arch}__{shape_name}__{mesh_tag}{('__' + tag) if tag else ''}.json"
    with open(os.path.join(out_dir, fname), "w") as f:
        json.dump(result, f, indent=1)
    print(f"[dryrun] {arch} x {shape_name} x {mesh_tag}: "
          f"step={result['step_seconds']:.1f}s "
          f"dominant={result['roofline'].get('dominant')} "
          f"plan_hit_rate={result['policy_plan'].get('plan_cache_hit_rate', 'n/a')} "
          f"-> {fname}")
    print(json.dumps(result["memory_analysis"]))
    print(json.dumps(result["cost_analysis"]))
    return result


def sweep(out_dir: str, meshes=("single", "multi"), cells=None,
          timeout_s: int = 5400, jobs: int = 1):
    """Run every runnable cell in an isolated subprocess; JSON per cell.
    A cell that waits on another ROADMAP item fails (its reason in the
    summary)."""
    from concurrent.futures import ThreadPoolExecutor

    cells = cells or runnable_cells()
    # Riskiest/heaviest archs first so failures surface early.
    risk = ["llama-3.2-vision-90b", "zamba2-2.7b", "mamba2-1.3b",
            "phi3.5-moe-42b-a6.6b", "whisper-small", "qwen2.5-32b"]
    cells = sorted(
        cells, key=lambda c: (risk.index(c[0]) if c[0] in risk else 99)
    )
    work = []
    for mesh_tag in meshes:
        for arch, shape_name in cells:
            fname = os.path.join(
                out_dir, f"{arch}__{shape_name}__{mesh_tag}.json"
            )
            if os.path.exists(fname):
                print(f"[sweep] skip existing {fname}")
                continue
            work.append((arch, shape_name, mesh_tag))

    failures = []

    def run_one(item):
        arch, shape_name, mesh_tag = item
        cmd = [
            sys.executable, "-m", "repro_torch.launch.dryrun",
            "--arch", arch, "--shape", shape_name, "--mesh", mesh_tag,
            "--out", out_dir,
        ] + (["--no-counting"] if mesh_tag == "multi" else [])
        print("[sweep]", " ".join(cmd), flush=True)
        try:
            r = subprocess.run(
                cmd, capture_output=True, text=True, timeout=timeout_s
            )
            if r.returncode != 0:
                failures.append((arch, shape_name, mesh_tag, r.stderr[-2500:]))
                print(f"[sweep] FAIL {arch} {shape_name} {mesh_tag}:\n"
                      f"{r.stderr[-2500:]}", flush=True)
            else:
                print(f"[sweep] OK {arch} {shape_name} {mesh_tag}", flush=True)
        except subprocess.TimeoutExpired:
            failures.append((arch, shape_name, mesh_tag, "timeout"))
            print(f"[sweep] TIMEOUT {arch} {shape_name} {mesh_tag}", flush=True)

    with ThreadPoolExecutor(max_workers=jobs) as pool:
        list(pool.map(run_one, work))
    print(f"[sweep] done, {len(failures)} failures")
    for f in failures:
        last = f[3].strip().splitlines()[-1:] if f[3] else [""]
        print("  FAIL:", f[0], f[1], f[2], "|", last[0][:200])
    return failures


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--mesh", choices=["single", "multi"], default="single")
    ap.add_argument("--out", default=ARTIFACT_DIR)
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--remat", default="save_dots",
                    choices=[p.value for p in RematPolicy])
    ap.add_argument("--grad-reduce-dtype", default="float32")
    ap.add_argument("--microbatch", type=int, default=1)
    ap.add_argument("--zero1", action="store_true", default=True)
    ap.add_argument("--tag", default="")
    ap.add_argument("--jobs", type=int, default=1)
    ap.add_argument("--no-counting", action="store_true")
    ap.add_argument("--fsdp", default="auto", choices=["auto", "on", "off"])
    ap.add_argument("--moe-dispatch", default="dense", choices=["dense", "sorted"])
    ap.add_argument("--smoke", action="store_true",
                    help="the arch's SMOKE config (tests)")
    args = ap.parse_args()

    if args.sweep:
        failures = sweep(args.out, jobs=args.jobs)
        sys.exit(1 if failures else 0)

    knobs = dict(
        remat=args.remat,
        grad_reduce_dtype=args.grad_reduce_dtype,
        microbatch=args.microbatch,
        zero1=args.zero1,
    )
    if args.fsdp != "auto":
        knobs["fsdp"] = args.fsdp == "on"
    if args.moe_dispatch != "dense":
        knobs["moe_dispatch"] = args.moe_dispatch
    try:
        run_cell(
            args.arch, args.shape, args.mesh == "multi", args.out,
            tag=args.tag, counting=not args.no_counting, smoke=args.smoke,
            **knobs,
        )
    except Exception:
        traceback.print_exc()
        sys.exit(1)


if __name__ == "__main__":
    main()
