"""The port's ``launch/`` (``specs``, ``roofline``, ``dryrun``, ``report``)
and ``models.registry.runnable_cells`` held against the JAX package's.

* Torch twins of ``tests/test_dryrun_smoke.py``: the olmoe-1b-7b x
  ``decode_32k`` cell run by ``python -m repro_torch.launch.dryrun`` in a
  subprocess on ``"meta"`` over the 256-rank fake group (the reference's
  assertions, the reference's knobs, no ``jax`` imported); the collective
  record of the reference test's all-gather and all-reduce, issued
  through the port's ``collectives`` on a small fake group, against
  ``repro.launch.roofline.parse_collectives`` of the same two HLO lines;
  ``model_flops`` for every runnable cell.
* ``plan_model_policies`` equal to the reference's dict (the twin of
  ``tests/test_planner_sweep.py``'s plan-cache test) on the reference's
  chip.
* ``input_specs``: leaf paths, shapes and dtype names equal to the
  reference's ``jax.eval_shape`` trees (the port's per-layer leaves
  stacked; the sink position the port's self K/V rings carry taken off).
* ``roofline_terms`` equal to the reference's under ``hw.V5E``.
* A cell's per-rank parameter, optimizer and cache bytes equal the bytes
  of the reference's ``param_spec``/``opt_shardings``/``cache_spec``
  blocks, worked out from its PartitionSpecs and the mesh's axis sizes:
  the olmoe decode cell's, the cache of each serving cell of the
  mamba2, zamba2, whisper and VLM families (their split cache, every
  leaf; long_500k's sequence over ``data``), and the VLM FSDP train
  cell's parameters.
* A multi-pod train cell's reused microbatch count capped at the rank's
  rows.
* Every runnable cell runs; a train cell asked for FSDP of a family
  without it fails at once naming its ROADMAP item.
* zamba2-2.7b x long_500k at full size in a subprocess with no jax.
* One multi-pod train cell (minicpm-2b SMOKE, ``(pod, data, model)``) in
  a subprocess.
* One FSDP train cell (olmoe-1b-7b at full width, 2 layers) in a
  subprocess: its parameter and optimizer bytes are the reference's
  ``param_spec(..., fsdp=True)``/``opt_shardings`` blocks, and its step
  records all-gathers over ``data`` and reduce-scatters.
"""
import dataclasses
import json
import math
import os
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AbstractMesh, NamedSharding  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro import hw as rhw  # noqa: E402
from repro.configs.base import SHAPES as RSHAPES  # noqa: E402
from repro.distributed import sharding as rsh  # noqa: E402
from repro.launch import roofline as rroof  # noqa: E402
from repro.launch import specs as rspecs  # noqa: E402
from repro.models import get_config as rconfig  # noqa: E402
from repro.models import registry as rregistry  # noqa: E402
from repro.train import optimizer as ropt  # noqa: E402
from repro_torch import hw as thw  # noqa: E402
from repro_torch.configs.base import SHAPES as TSHAPES  # noqa: E402
from repro_torch.distributed import sharding as tsh  # noqa: E402
from repro_torch.launch import dryrun as tdry  # noqa: E402
from repro_torch.launch import report as treport  # noqa: E402
from repro_torch.launch import roofline as troof  # noqa: E402
from repro_torch.launch import specs as tspecs  # noqa: E402
from repro_torch.launch.mesh import MeshShape  # noqa: E402
from repro_torch.models import ARCHS, runnable_cells  # noqa: E402
from repro_torch.models import get_config as tconfig  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
KINDS = ("train_4k", "prefill_32k", "decode_32k")
# Run a script and fail if jax or the reference package was imported.
_RUN_NO_JAX_SCRIPT = (
    "import sys; exec(sys.argv[1]); "
    "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
    "('jax', 'jaxlib', 'repro')); assert not bad, bad")
# Run a module as ``__main__`` and fail if jax or the reference package
# was imported on the way.
_RUN_NO_JAX = (
    "import runpy, sys; sys.argv = sys.argv[1:]; "
    "runpy.run_module(sys.argv[0], run_name='__main__', alter_sys=True); "
    "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
    "('jax', 'jaxlib', 'repro')); assert not bad, bad")


def _dryrun(tmp, *args) -> dict:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run(
        [sys.executable, "-c", _RUN_NO_JAX, "repro_torch.launch.dryrun",
         *args, "--out", str(tmp)],
        capture_output=True, text=True, timeout=600, env=env, cwd=ROOT)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    return r


@pytest.fixture(scope="module")
def olmoe_record(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dryrun")
    _dryrun(tmp, "--arch", "olmoe-1b-7b", "--shape", "decode_32k",
            "--mesh", "single")
    out = tmp / "olmoe-1b-7b__decode_32k__single.json"
    assert out.exists()
    return json.loads(out.read_text())


@pytest.fixture(scope="module")
def multi_record(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dryrun_multi")
    _dryrun(tmp, "--arch", "minicpm-2b", "--shape", "train_4k",
            "--mesh", "multi", "--smoke")
    return json.loads(
        (tmp / "minicpm-2b__train_4k__multi.json").read_text())


def test_dryrun_single_cell(olmoe_record):
    """The reference test's assertions on the port's record."""
    rec = olmoe_record
    rl = rec["roofline"]
    assert rl["dominant"] in ("compute", "memory", "collective")
    assert rl["t_memory_s"] > 0
    assert rec["counted"]["flops"] > 0
    assert rec["memory_analysis"]["temp_size_in_bytes"] > 0
    assert rec["mesh"] == {"data": 16, "model": 16}
    assert rec["collectives_scanned_module_raw"]["total_count"] > 0


def _reference_knobs(arch, shape_name, smoke=False):
    """The knobs the reference's ``run_cell`` starts a cell with (its CLI
    defaults and rules; the multi-pod cells reuse the single-pod ones)."""
    knobs = dict(remat="save_dots", grad_reduce_dtype="float32",
                 microbatch=1, zero1=True)

    class _M:
        shape = {"data": 16, "model": 16}

    knobs["fsdp"] = rsh.fsdp_needed(rconfig(arch, smoke=smoke), _M,
                                    train=RSHAPES[shape_name].kind == "train")
    if RSHAPES[shape_name].kind == "train":
        knobs.update(remat="recompute", microbatch=4)
    return knobs


def test_dryrun_knobs_are_the_reference_rules(olmoe_record, multi_record):
    assert olmoe_record["knobs"] == _reference_knobs("olmoe-1b-7b",
                                                     "decode_32k")
    assert multi_record["knobs"] == _reference_knobs("minicpm-2b",
                                                     "train_4k", smoke=True)


@pytest.mark.parametrize("single_mb, want", [(4, 4), (16, 8)])
def test_multi_pod_cell_caps_the_reused_microbatch(tmp_path, single_mb,
                                                   want):
    """A multi-pod train cell reuses the single-pod record's knobs, its
    microbatch count capped at the rank's 8 rows (256 over 2 x 16)."""
    knobs = dict(_reference_knobs("minicpm-2b", "train_4k"),
                 remat="recompute", microbatch=single_mb)
    (tmp_path / "minicpm-2b__train_4k__single.json").write_text(
        json.dumps({"knobs": knobs}))
    got = tdry.cell_knobs("minicpm-2b", "train_4k", True, str(tmp_path))
    assert got == dict(knobs, microbatch=want)
    assert tdry.rank_rows("train_4k", False) == 16


def _block_bytes(shape, spec, sizes, itemsize) -> int:
    """Bytes of one rank's block of a ``shape`` leaf under a reference
    PartitionSpec on a mesh of axis ``sizes``."""
    n = math.prod(shape)
    for part in spec:
        for axis in ((part,) if isinstance(part, str) else part or ()):
            n //= sizes[axis]
    return n * itemsize


def _tree_blocks(tree, spec_of, sizes, itemsize=None) -> int:
    total = 0
    for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]:
        size = itemsize or jnp.dtype(x.dtype).itemsize
        total += _block_bytes(tuple(x.shape), spec_of(path, x), sizes, size)
    return total


def test_cell_bytes_equal_the_reference_blocks(olmoe_record):
    """The decode cell's per-rank parameter and cache bytes against the
    reference's ``param_spec``/``cache_spec`` blocks on the 16 x 16 mesh
    (the port's rings add one sink position a row; its lengths are its
    rows, the reference's replicated)."""
    cfg = rconfig("olmoe-1b-7b")
    shape = RSHAPES["decode_32k"]
    mesh = AbstractMesh((16, 16), ("data", "model"))
    sizes = {"data": 16, "model": 16}
    specs = rspecs.input_specs("olmoe-1b-7b", "decode_32k")
    params = _tree_blocks(specs["params"], lambda path, x: rsh.param_spec(
        rsh._path_str(path), tuple(x.shape), cfg, mesh), sizes)
    cspec = rsh.cache_spec(cfg, mesh, shape.global_batch)
    kv = {k: v for k, v in specs["cache"]["layers"].items()}
    cache = _tree_blocks({"layers": kv}, lambda path, x: cspec(
        rsh._path_str(path), x), sizes)
    parts = olmoe_record["argument_parts"]
    assert parts["params"] == params
    assert parts["cache"] == cache
    b_l = shape.global_batch // 16
    assert parts["cache_sink"] == (2 * cfg.n_layers * b_l * cfg.n_kv_heads
                                   * cfg.head_dim_ * 2)
    assert parts["cache_lengths"] == b_l * 4
    assert parts["inputs"] == b_l * 1 * 4
    assert olmoe_record["memory_analysis"]["argument_size_in_bytes"] == sum(
        parts.values())


def test_multi_pod_train_cell(multi_record):
    """minicpm-2b SMOKE x train_4k on (pod, data, model) = (2, 16, 16):
    the batch over (pod, data), ZeRO-1 moments over data; its parameter
    and optimizer bytes are the reference's blocks."""
    rec = multi_record
    assert rec["mesh"] == {"pod": 2, "data": 16, "model": 16}
    assert rec["n_chips"] == 512
    assert rec["memory_analysis"]["temp_size_in_bytes"] > 0
    assert rec["counted"]["coll_count"] > 0
    cfg = rconfig("minicpm-2b", smoke=True)
    mesh = AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    sizes = {"pod": 2, "data": 16, "model": 16}
    state = rspecs.input_specs("minicpm-2b", "train_4k", smoke=True)["state"]

    def pspec(path, x):
        return rsh.param_spec(rsh._path_str(path), tuple(x.shape), cfg, mesh)

    params = _tree_blocks(state["params"], pspec, sizes)
    pshard = jax.tree_util.tree_map_with_path(
        lambda path, x: NamedSharding(mesh, P(*pspec(path, x))),
        state["params"])
    mu = ropt.opt_shardings(pshard, state["params"], mesh, zero1=True)["mu"]
    flat_mu = jax.tree_util.tree_leaves(mu)
    flat_p = jax.tree_util.tree_leaves(state["params"])
    moments = sum(_block_bytes(tuple(x.shape), s.spec, sizes, 4)
                  for x, s in zip(flat_p, flat_mu))
    parts = rec["argument_parts"]
    assert parts["params"] == params
    assert parts["opt"] == 2 * moments + 4          # mu, nu and the count
    rows = TSHAPES["train_4k"].global_batch // 32
    assert parts["inputs"] == 2 * rows * TSHAPES["train_4k"].seq_len * 4


_FSDP_CELL_SCRIPT = """
import dataclasses, json, traceback, weakref
import torch
from repro_torch.distributed import collectives, fsdp
from repro_torch.launch import dryrun
from repro_torch.models import get_config
cfg = dataclasses.replace(get_config("olmoe-1b-7b"), n_layers=2)
mesh = dryrun.production_mesh(False)
data = mesh.get_group("data")
by_group = {"all-gather": {}, "reduce-scatter": {}}
for kind, name in (("all-gather", "all_gather"),
                   ("reduce-scatter", "reduce_scatter")):
    def wrap(fn, kind=kind):
        def call(t, group=None, **kw):
            axis = "data" if group is data else "other"
            by_group[kind][axis] = by_group[kind].get(axis, 0) + 1
            return fn(t, group, **kw)
        return call
    setattr(collectives, name, wrap(getattr(collectives, name)))
# The bytes of the weights a layer body gathers: made in all, and live
# at once (each storage until it is freed).
layer = {"calls": 0, "made": 0, "live": 0, "peak": 0}
def free(nbytes):
    layer["live"] -= nbytes
def gather(x, group, dim, inner=fsdp._gather):
    out = inner(x, group, dim)
    if any(f.name in ("layer_body", "group_body")
           for f in traceback.extract_stack()):
        st = out.untyped_storage()
        layer["calls"] += 1
        layer["made"] += st.nbytes()
        layer["live"] += st.nbytes()
        layer["peak"] = max(layer["peak"], layer["live"])
        weakref.finalize(st, free, st.nbytes())
    return out
fsdp._gather = gather
_, _, _, step, arguments, parts = dryrun.build_cell(
    "olmoe-1b-7b", "train_4k", multi_pod=False, remat="recompute",
    microbatch=4, zero1=True, fsdp=True, cfg=cfg)
counted = dryrun.count_step(step, arguments)
print(json.dumps({"parts": parts, "by_group": by_group,
                  "colls": counted["colls"], "layer_gathers": layer}))
"""


def test_fsdp_train_cell_runs_on_meta():
    """olmoe-1b-7b x train_4k x single at full width and 2 layers with
    FSDP: the rank's parameter and optimizer bytes equal the reference's
    ``param_spec(..., fsdp=True)`` and ZeRO-1 ``opt_shardings`` blocks on
    the 16 x 16 mesh, the step runs on meta, and its collective record
    holds all-gathers over ``data`` and reduce-scatters over it.  Under
    ``recompute`` each microbatch gathers every layer's weights twice (in
    the forward and again in the backward's recompute) and no more than
    one layer's gathered weights are live at once: none is kept from the
    forward to the backward."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", _RUN_NO_JAX_SCRIPT,
                        _FSDP_CELL_SCRIPT], capture_output=True, text=True,
                       timeout=600, env=env, cwd=ROOT)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    got = json.loads(r.stdout.strip().splitlines()[-1])
    rcfg = dataclasses.replace(rconfig("olmoe-1b-7b"), n_layers=2)
    mesh = AbstractMesh((16, 16), ("data", "model"))
    sizes = {"data": 16, "model": 16}
    state = rspecs.input_specs("olmoe-1b-7b", "train_4k", cfg=rcfg)["state"]

    def pspec(path, x):
        return rsh.param_spec(rsh._path_str(path), tuple(x.shape), rcfg,
                              mesh, fsdp=True)

    params = _tree_blocks(state["params"], pspec, sizes)
    pshard = jax.tree_util.tree_map_with_path(
        lambda path, x: NamedSharding(mesh, P(*pspec(path, x))),
        state["params"])
    mu = ropt.opt_shardings(pshard, state["params"], mesh, zero1=True)["mu"]
    moments = sum(_block_bytes(tuple(x.shape), s.spec, sizes, 4)
                  for x, s in zip(jax.tree_util.tree_leaves(state["params"]),
                                  jax.tree_util.tree_leaves(mu)))
    whole = _tree_blocks(state["params"], lambda path, x: rsh.param_spec(
        rsh._path_str(path), tuple(x.shape), rcfg, mesh), sizes)
    assert got["parts"]["params"] == params < whole
    assert got["parts"]["opt"] == 2 * moments + 4
    per_kind = got["colls"]["per_kind"]
    assert got["by_group"]["all-gather"].get("data", 0) > 0
    assert got["by_group"]["reduce-scatter"] == {
        "data": per_kind["reduce-scatter"]["count"]}
    assert per_kind["reduce-scatter"]["count"] > 0
    layer = got["layer_gathers"]
    microbatches, gathers_a_layer = 4, 2
    one_layer = layer["made"] / (microbatches * gathers_a_layer
                                 * rcfg.n_layers)
    assert layer["calls"] % (microbatches * gathers_a_layer
                             * rcfg.n_layers) == 0
    assert 0 < layer["peak"] <= one_layer
    assert layer["live"] == 0


_COLLECTIVE_SCRIPT = """
import json, sys
import torch, torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.distributed import collectives
from repro_torch.launch import roofline
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=16)
four = dist.new_group([0, 1, 2, 3])
with collectives.recording() as notes:
    collectives.all_gather(torch.empty((4, 512, 128), dtype=torch.bfloat16,
                                       device="meta"), four)
    collectives.all_reduce(torch.empty(1024, device="meta"))
dist.destroy_process_group()
print(json.dumps(roofline.collective_record(notes)))
"""


def test_collective_record_matches_parse_collectives():
    """The reference test's all-gather (bf16[16,512,128] over 4 ranks) and
    all-reduce (f32[1024] over 16), issued through the port's collectives
    on a 16-rank fake group, against the reference's parse of the same two
    HLO lines: equal ``per_kind`` and totals."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", _COLLECTIVE_SCRIPT],
                       capture_output=True, text=True, timeout=300, env=env,
                       cwd=ROOT)
    assert r.returncode == 0, r.stderr[-2000:]
    got = json.loads(r.stdout.strip().splitlines()[-1])
    hlo = """
  %ag = bf16[16,512,128]{2,1,0} all-gather(%p0), replica_groups={{0,1,2,3}}, dimensions={0}
  %ar.1 = f32[1024]{0} all-reduce(%p1), replica_groups=[16,16]<=[256], to_apply=%add
"""
    want = rroof.parse_collectives(hlo)
    assert got == json.loads(json.dumps(want))


@pytest.mark.parametrize("kind", ["all-gather", "all-reduce",
                                  "reduce-scatter", "all-to-all",
                                  "collective-permute"])
def test_moved_bytes_match_the_reference(kind):
    for group in range(2, 513):
        for rb in (1.0, 4096.0, 3 * 2.0 ** 30):
            assert troof._moved_bytes(kind, rb, group) == \
                rroof._moved_bytes(kind, rb, group), (kind, group, rb)


def test_model_flops_match_the_reference_for_every_cell():
    for arch, shape in runnable_cells():
        assert troof.model_flops(tconfig(arch), TSHAPES[shape]) == \
            rroof.model_flops(rconfig(arch), RSHAPES[shape]), (arch, shape)


def test_runnable_cells_equal_the_reference():
    assert runnable_cells() == rregistry.runnable_cells()
    assert len(runnable_cells()) == 32


def test_roofline_terms_match_the_reference():
    cost = {"flops": 3.1e13, "bytes accessed": 7.7e11}
    colls = {"total_moved_bytes": 2.5e9}
    mem = {"argument_size_in_bytes": 3 << 30, "temp_size_in_bytes": 5 << 30}

    class _RMesh:
        shape = {"data": 16, "model": 16}

    for arch, shape in (("yi-9b", "train_4k"), ("olmoe-1b-7b", "decode_32k"),
                        ("phi3.5-moe-42b-a6.6b", "prefill_32k")):
        got = troof.roofline_terms(tconfig(arch), TSHAPES[shape],
                                   MeshShape(("data", "model"), (16, 16)),
                                   cost, colls, mem, chip=thw.V5E)
        want = rroof.roofline_terms(rconfig(arch), RSHAPES[shape], _RMesh,
                                    cost, colls, mem, chip=rhw.V5E)
        assert got == want, (arch, shape)


@pytest.mark.parametrize("arch, shape", [("yi-9b", "decode_32k"),
                                         ("olmoe-1b-7b", "prefill_32k")])
def test_plan_model_policies_equal_the_reference(arch, shape):
    from repro.launch.dryrun import plan_model_policies as rplan

    got = tdry.plan_model_policies(tconfig(arch), TSHAPES[shape],
                                   chip="tpu-v5e")
    assert got == rplan(rconfig(arch), RSHAPES[shape])
    assert got["plan_cache_hit_rate"] > 0.8
    assert got["ops_planned"] == got["layers"] * got["ops_per_layer"]


def _ref_leaves(tree) -> dict:
    return {rsh._path_str(path): (tuple(x.shape), str(x.dtype))
            for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_leaves(tree, cache: bool) -> dict:
    """The port's tree as the reference stacks it: list indices dropped,
    list lengths prepended; a self K/V ring's sink position taken off."""
    out = {}
    for path, lead, x in tsh._stacked_leaves(tree):
        key = tsh.stacked_path(path)
        shape = tuple(lead) + tuple(x.shape)
        if cache and key.split("/")[-1] in ("k", "v") and "cross" not in key:
            shape = shape[:-3] + (shape[-3] - 1,) + shape[-2:]
        v = (shape, str(x.dtype).removeprefix("torch."))
        assert out.setdefault(key, v) == v, key
    return out


def _check_specs(arch, shape, smoke):
    want = rspecs.input_specs(arch, shape, smoke=smoke)
    got = tspecs.input_specs(arch, shape, smoke=smoke)
    assert got["kind"] == want["kind"]
    assert sorted(got) == sorted(want)
    for key in want:
        if key == "kind":
            continue
        assert _port_leaves(got[key], key == "cache") == \
            _ref_leaves(want[key]), (arch, shape, key)
        assert all(t.device.type == "meta" for t in
                   torch.utils._pytree.tree_leaves(got[key])
                   if isinstance(t, torch.Tensor))


@pytest.mark.parametrize("shape", KINDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_match_the_reference_at_smoke(arch, shape):
    _check_specs(arch, shape, smoke=True)


@pytest.mark.parametrize("shape", KINDS)
@pytest.mark.parametrize("arch", ["yi-9b", "olmoe-1b-7b"])
def test_input_specs_match_the_reference_at_full_size(arch, shape):
    _check_specs(arch, shape, smoke=False)


def test_eval_shape_state_is_meta_and_cached():
    from repro_torch.train.step import eval_shape_state

    cfg, model, state = eval_shape_state("yi-9b", smoke=True)
    assert eval_shape_state("yi-9b", smoke=True)[2] is state
    leaves = torch.utils._pytree.tree_leaves(state)
    assert leaves and all(t.device.type == "meta" for t in leaves)
    want = rspecs.input_specs("yi-9b", "train_4k", smoke=True)["state"]
    assert _port_leaves(state, False) == _ref_leaves(want)


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch, shape, item", [
    ("mamba2-1.3b", "train_4k", "item 3"),
    ("zamba2-2.7b", "train_4k", "item 3"),
    ("whisper-small", "train_4k", "item 3"),
])
def test_waiting_cells_fail_at_once_naming_their_item(arch, shape, item,
                                                      multi_pod):
    """A train cell asked for FSDP of a family without it (mamba2, zamba2,
    whisper: no cell at the rules' defaults) raises before anything is
    built (no process group is made)."""
    with pytest.raises(NotImplementedError, match=f"ROADMAP queue 1 {item}"):
        tdry.build_cell(arch, shape, multi_pod=multi_pod, zero1=True,
                        fsdp=True)
    assert not torch.distributed.is_initialized()


def test_waiting_cells_are_the_complement_of_this_slice():
    """Every runnable cell runs at the rules' defaults: all 32 (the
    serving cells of every family on its split cache, the six FSDP
    ``train_4k`` cells)."""
    runs = []
    for arch, shape in runnable_cells():
        cfg = tconfig(arch)
        fsdp = tsh.fsdp_needed(cfg, MeshShape(("data", "model"), (16, 16)),
                               train=TSHAPES[shape].kind == "train")
        if tdry.waits_on(cfg, TSHAPES[shape], fsdp) is None:
            runs.append((arch, shape))
    assert sorted(runs) == sorted(runnable_cells())
    assert len(runs) == 32


# The serving cells of the families whose split cache came last: their
# caches hold SSM state, conv windows, cross K/V and vision tokens beside
# the self K/V, and long_500k splits its one sequence over ``data``.
NEW_SERVE_CELLS = [(a, s) for a in ("mamba2-1.3b", "zamba2-2.7b")
                   for s in ("prefill_32k", "decode_32k", "long_500k")] + [
    (a, s) for a in ("whisper-small", "llama-3.2-vision-90b")
    for s in ("prefill_32k", "decode_32k")]
# The VLM's FSDP train cell at its first rung (its stacked self-layer
# norms are over the rule's 1 MiB line, so FSDP splits them too).
VLM_TRAIN_KNOBS = dict(remat="recompute", microbatch=4, zero1=True)
_CELL_PARTS_SCRIPT = (
    "import json\n"
    "from repro_torch.launch import dryrun\n"
    f"cells = {NEW_SERVE_CELLS!r}\n"
    "out = {f'{a}|{s}': dryrun.build_cell(a, s, False)[-1]\n"
    "       for a, s in cells}\n"
    "out['llama-3.2-vision-90b|train_4k'] = dryrun.build_cell(\n"
    "    'llama-3.2-vision-90b', 'train_4k', False,\n"
    f"    **{VLM_TRAIN_KNOBS!r})[-1]\n"
    "print(json.dumps(out))\n")


@pytest.fixture(scope="module")
def new_cell_parts():
    """Each new serving cell, and the VLM's FSDP train cell, built on meta
    over the 16 x 16 fake group (no step run) in one subprocess with no
    jax: its argument bytes by part."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", _RUN_NO_JAX_SCRIPT,
                        _CELL_PARTS_SCRIPT], capture_output=True, text=True,
                       timeout=600, env=env, cwd=ROOT)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


def _reference_cache_parts(arch, shape_name) -> dict:
    """The reference's cache bytes a rank on 16 x 16 from
    ``rspecs.input_specs`` (``eval_shape`` only): the ``cache_spec``
    blocks of every leaf but the cursors, the port's sink positions (one
    a self K/V block row: the block's bytes over its sequence length),
    and the port's cursors (the rank's rows)."""
    cfg = rconfig(arch)
    shape = RSHAPES[shape_name]
    mesh = AbstractMesh((16, 16), ("data", "model"))
    sizes = {"data": 16, "model": 16}
    cache = rspecs.input_specs(arch, shape_name)["cache"]
    cspec = rsh.cache_spec(cfg, mesh, shape.global_batch,
                           long_context=shape_name == "long_500k")
    blocks = sinks = 0
    for path, x in jax.tree_util.tree_flatten_with_path(cache)[0]:
        p = rsh._path_str(path)
        if p == "lengths":
            continue
        spec = cspec(path, x)
        n = _block_bytes(tuple(x.shape), spec, sizes,
                         jnp.dtype(x.dtype).itemsize)
        blocks += n
        if p.endswith(("/k", "/v")) and "cross" not in p:
            seq = x.shape[-3]
            for axis in ((spec[-3],) if isinstance(spec[-3], str)
                         else spec[-3] or ()):
                seq //= sizes[axis]
            sinks += n // seq
    b = rsh._batch_rule(mesh, shape.global_batch)
    rows = shape.global_batch // (16 if b else 1)
    return {"cache": blocks, "cache_sink": sinks, "cache_lengths": rows * 4}


@pytest.mark.parametrize("arch, shape", NEW_SERVE_CELLS)
def test_new_serving_cells_hold_the_reference_cache_blocks(
        new_cell_parts, arch, shape):
    """The port's per-rank cache bytes of each mamba2, zamba2, whisper and
    VLM serving cell equal the reference's ``cache_spec`` blocks on the
    16 x 16 mesh (``build_cell`` holds each leaf's block against the
    rank's meta tensor)."""
    got = new_cell_parts[f"{arch}|{shape}"]
    want = _reference_cache_parts(arch, shape)
    for key in ("cache", "cache_sink", "cache_lengths"):
        assert got[key] == want[key], (key, got[key], want[key])


def test_vlm_fsdp_train_cell_holds_the_reference_param_blocks(
        new_cell_parts):
    """The VLM's train cell with FSDP (its default) holds the reference's
    ``param_spec(..., fsdp=True)`` blocks on the 16 x 16 mesh, its
    stacked self-layer norms split over ``data`` among them."""
    rcfg = rconfig("llama-3.2-vision-90b")
    mesh = AbstractMesh((16, 16), ("data", "model"))
    state = rspecs.input_specs("llama-3.2-vision-90b", "train_4k")["state"]
    params = _tree_blocks(state["params"], lambda path, x: rsh.param_spec(
        rsh._path_str(path), tuple(x.shape), rcfg, mesh, fsdp=True),
        {"data": 16, "model": 16})
    assert new_cell_parts["llama-3.2-vision-90b|train_4k"]["params"] == (
        params)


def test_long_context_cell_runs_without_jax(tmp_path):
    """zamba2-2.7b x long_500k x single at full size through the CLI in a
    subprocess with no jax: the one sequence's K/V split over ``data``
    (its KV heads over ``model``), the decode step's partials merged by
    all-reduces; its cache bytes the reference's blocks."""
    _dryrun(tmp_path, "--arch", "zamba2-2.7b", "--shape", "long_500k",
            "--mesh", "single")
    rec = json.loads(
        (tmp_path / "zamba2-2.7b__long_500k__single.json").read_text())
    assert rec["mesh"] == {"data": 16, "model": 16}
    assert rec["roofline"]["t_memory_s"] > 0
    parts = rec["argument_parts"]
    want = _reference_cache_parts("zamba2-2.7b", "long_500k")
    assert {k: parts[k] for k in want} == want
    colls = rec["collectives_scanned_module_raw"]
    assert colls["per_kind"]["all-reduce"]["count"] > 0


def test_report_tabulates_records(olmoe_record, multi_record, tmp_path):
    for name, rec in (("olmoe-1b-7b__decode_32k__single.json", olmoe_record),
                      ("minicpm-2b__train_4k__multi.json", multi_record)):
        (tmp_path / name).write_text(json.dumps(rec))
    rows = treport.load(str(tmp_path))
    table = treport.dryrun_table(rows)
    assert "| olmoe-1b-7b | decode_32k | 16x16 |" in table
    assert "| minicpm-2b-smoke | train_4k | 2x16x16 |" in table
    roof = treport.roofline_table(rows, "single")
    assert "olmoe-1b-7b" in roof and "minicpm-2b" not in roof


def test_count_step_counts_flops_bytes_and_peak():
    """The account on a small CPU step: a matmul's FLOPs, an op's inputs
    and outputs, the live peak of the storages it makes, views counting
    zero."""
    a = torch.randn(64, 32)
    b = torch.randn(32, 16)

    def step():
        u = (a @ b).t()             # 64 x 16 fp32: 4096 bytes; a view of it
        return (u * 2).sum()        # a new 4096-byte storage, then 4 bytes

    got = tdry.count_step(step, [a, b])
    assert got["cost"]["flops"] == 2 * 64 * 32 * 16
    assert got["cost"]["bytes accessed"] == (
        (64 * 32 + 32 * 16 + 64 * 16) * 4       # mm
        + 2 * 64 * 16 * 4                        # mul
        + (64 * 16 + 1) * 4)                     # sum
    assert got["mem"]["argument_size_in_bytes"] == (64 * 32 + 32 * 16) * 4
    assert got["mem"]["temp_size_in_bytes"] == 2 * 64 * 16 * 4 + 4
    assert got["mem"]["output_size_in_bytes"] == 4
    assert got["colls"]["total_count"] == 0


@pytest.mark.parametrize("name", ["specs", "roofline", "dryrun", "report",
                                  "mesh"])
def test_launch_modules_import_no_jax(name):
    """The port's AST import rule over each ``launch/`` module."""
    import ast

    path = ROOT / "src" / "repro_torch" / "launch" / f"{name}.py"
    tree = ast.parse(path.read_text())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names]
    names += [n.module for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.level == 0]
    assert not [m for m in names
                if m.split(".")[0] in ("jax", "jaxlib", "repro")]


def test_every_collective_goes_through_the_recorded_functions():
    """The collective record sees every collective the port issues: no
    module but ``distributed/collectives.py`` calls a ``torch.distributed``
    collective (the checkpoint's ``barrier`` moves no data)."""
    import ast

    names = {"all_reduce", "all_gather", "all_gather_into_tensor",
             "reduce_scatter", "reduce_scatter_tensor", "all_to_all",
             "all_to_all_single", "broadcast", "reduce", "gather",
             "scatter", "send", "recv", "isend", "irecv"}
    bad = []
    for path in sorted((ROOT / "src" / "repro_torch").rglob("*.py")):
        if path.name == "collectives.py" and path.parent.name == "distributed":
            continue
        for node in ast.walk(ast.parse(path.read_text())):
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in names
                    and isinstance(node.func.value, ast.Name)
                    and node.func.value.id == "dist"):
                bad.append((str(path.relative_to(ROOT)), node.lineno))
    assert bad == []
