"""The port's distribution layer (``repro_torch.distributed``,
``repro_torch.launch.mesh``, the trainer's data-parallel ZeRO-1 half) held
against the JAX package's.

* Rules: ``param_spec``, ``batch_spec``, ``cache_spec``, ``fsdp_needed``
  and ``opt_shardings`` equal the reference's for every registry config
  (SMOKE and CONFIG, shapes from ``jax.eval_shape``) on every mesh shape
  (data in {1, 2, 4, 16} x model in {1, 2, 4, 8, 16}, and 2 x 16 x 16 with
  a pod axis), with and without FSDP / ZeRO-1.  The reference reads only a
  mesh's ``shape`` and ``axis_names``, so it gets a device-free
  ``AbstractMesh``; the port its ``MeshShape``.  The port's per-layer
  leaves get the reference's spec with the stacked axes dropped; the
  leaves where FSDP or ZeRO-1 picks a stacked axis are listed.
* Collectives and sequence-parallel decode at 4 gloo ranks against the
  reference's functions under ``jax.vmap(axis_name=)`` and its oracle.
* The data-parallel ZeRO-1 step (yi-9b SMOKE, batch 8 x 16, at 2 and 4
  ranks; olmoe SMOKE at 2 for the aux loss) against the port's
  one-process step and the reference's jitted one-device step on the same
  weights (loss rtol 1e-4, parameters 5e-3, the tolerances of
  ``tests/test_distributed.py``), parameters bitwise across ranks, moment
  blocks of 1/|data| of the bytes; elastic restore 2 -> 1 and 1 -> 2,
  bitwise.

Every multi-rank case runs in ranks spawned by ``tests/dist_workers.py``
(two spawns for the whole file, ``file://`` stores under tmp dirs, so no
port is fixed)."""
import dataclasses
import functools
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

import dist_workers  # noqa: E402
from repro.distributed import collectives as rcoll  # noqa: E402
from repro.distributed import sharding as rsh  # noqa: E402
from repro.distributed import sp_decode as rsp  # noqa: E402
from repro.kernels.decode_attention import ref as rdec  # noqa: E402
from repro.models import build_model as rbuild  # noqa: E402
from repro.models import get_config as rconfig  # noqa: E402
from repro.models.registry import ARCHS  # noqa: E402
from repro.train import optimizer as ropt  # noqa: E402
from repro.train import step as rstep  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.data.pipeline import SyntheticLM  # noqa: E402
from repro_torch.distributed import sharding as tsh  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.models import build_model as tbuild  # noqa: E402
from repro_torch.models import get_config as tconfig  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402
from repro_torch.utils import tree  # noqa: E402

torch.set_num_threads(1)
MESHES = [(d, m) for d in (1, 2, 4, 16) for m in (1, 2, 4, 8, 16)] + ["pod"]
# Where the reference's FSDP rule shards the stacked layer axis: the conv
# weight is (L, 4, width), width goes to `model`, and L is the largest
# free dim left.
FSDP_ON_LAYER_AXIS = {"mamba2-1.3b": {"layers/mamba/conv_w"},
                      "zamba2-2.7b": {"layers/mamba/conv_w"}}
# The reference's stacked subtrees (the port's per-layer lists).
STACKED = ("layers", "enc_layers", "dec_layers", "self_layers",
           "cross_layers")


def _meshes():
    """(port MeshShape, reference AbstractMesh) for every mesh shape."""
    for m in MESHES:
        if m == "pod":
            port = tmesh.make_production_mesh(multi_pod=True)
        else:
            port = tmesh.MeshShape(("data", "model"), m)
        yield port, AbstractMesh(port.sizes, port.axis_names)


def test_production_mesh_shapes():
    assert tmesh.make_production_mesh().shape == {"data": 16, "model": 16}
    assert tmesh.make_production_mesh(multi_pod=True).shape == {
        "pod": 2, "data": 16, "model": 16}
    assert tsh.batch_axes(tmesh.make_production_mesh(multi_pod=True)) == (
        "pod", "data")


@functools.lru_cache(maxsize=None)
def _shapes(arch: str, smoke: bool):
    """The reference's stacked parameter leaves: [(path, shape)]."""
    cfg = rconfig(arch, smoke=smoke)
    tree_ = jax.eval_shape(rbuild(cfg).init, jax.random.PRNGKey(0))
    flat = jax.tree_util.tree_flatten_with_path(tree_)[0]
    return tree_, [(rsh._path_str(p), tuple(x.shape)) for p, x in flat]


@pytest.mark.parametrize("arch", ARCHS)
def test_param_spec_equals_the_reference(arch):
    """Every stacked leaf of SMOKE and CONFIG, every mesh, FSDP on and
    off: the port's spec equals the reference's PartitionSpec."""
    for smoke in (True, False):
        rcfg, tcfg = rconfig(arch, smoke=smoke), tconfig(arch, smoke=smoke)
        for port, ref in _meshes():
            for fsdp in (False, True):
                for path, shape in _shapes(arch, smoke)[1]:
                    want = tuple(rsh.param_spec(path, shape, rcfg, ref,
                                                fsdp=fsdp))
                    got = tsh.param_spec(path, shape, tcfg, port, fsdp=fsdp)
                    assert got == want, (smoke, port, fsdp, path, shape)
            assert tsh.fsdp_needed(tcfg, port, True) == rsh.fsdp_needed(
                rcfg, ref, True)
            assert tsh.fsdp_needed(tcfg, port, False) == rsh.fsdp_needed(
                rcfg, ref, False)


def _first_leaf_keys(node, keys=()):
    """The dict keys down to the first leaf under ``node``."""
    while isinstance(node, (dict, list)):
        if isinstance(node, dict):
            k = sorted(node)[0]
            keys, node = keys + (k,), node[k]
        else:
            node = node[0]
    return keys


@functools.lru_cache(maxsize=None)
def _port_tree(arch: str, smoke: bool):
    """The port's parameter tree for ``arch`` as meta tensors: the SMOKE
    tree's structure (per-layer lists), each list as long as the
    reference's stacked axis, each leaf the stacked leaf's shape with the
    stacked axes removed."""
    structure = tbuild(tconfig(arch, smoke=True), "cpu").init(
        torch.Generator().manual_seed(0))
    ref = dict(_shapes(arch, smoke)[1])

    def build(node, keys, depth):
        if isinstance(node, dict):
            return {k: build(v, keys + (k,), depth) for k, v in node.items()}
        if isinstance(node, list):
            n = ref["/".join(_first_leaf_keys(node, keys))][depth]
            return [build(node[0], keys, depth + 1) for _ in range(n)]
        return torch.empty(ref["/".join(keys)][depth:], device="meta")

    return build(structure, (), 0)


@pytest.mark.parametrize("arch", ARCHS)
def test_port_tree_specs_drop_the_stacked_axes(arch, capsys):
    """``params_shardings`` on the port's own trees (per-layer lists, SMOKE
    and CONFIG): each leaf's spec is the reference's for its stacked leaf
    with the stacked axes removed.  Listed: the leaves where FSDP shards a
    stacked axis (the port's leaf then takes FSDP's rule on its own dims:
    the largest free data-divisible one): exactly FSDP_ON_LAYER_AXIS."""
    listed = {}
    for smoke in (True, False):
        rcfg, tcfg = rconfig(arch, smoke=smoke), tconfig(arch, smoke=smoke)
        params = _port_tree(arch, smoke)
        ref_shapes = dict(_shapes(arch, smoke)[1])
        for port, ref in _meshes():
            for fsdp in (False, True):
                got = tree.leaves(tsh.params_shardings(params, tcfg, port,
                                                       fsdp=fsdp))
                stacked, seen = [], {}
                for (path, leaf), sh in zip(tree.leaves_with_paths(params),
                                            got):
                    n = tree.stacked_axes(path)
                    rpath = tsh.stacked_path(path)
                    rshape = ref_shapes[rpath]
                    assert rshape[n:] == tuple(leaf.shape), path
                    if rpath not in seen:
                        seen[rpath] = tuple(rsh.param_spec(
                            rpath, rshape, rcfg, ref, fsdp=fsdp))
                    want = seen[rpath]
                    assert sh.mesh is port
                    if any(want[:n]):
                        stacked.append(tree.path_str(path))
                        assert sh.spec == tsh._add_fsdp(
                            want[n:], tuple(leaf.shape), port, min_bytes=0)
                        listed.setdefault(rpath, set()).add(
                            (smoke, port.sizes))
                    else:
                        assert sh.spec == want[n:], (port, fsdp, path)
                if not fsdp:
                    assert stacked == []
    assert set(listed) == FSDP_ON_LAYER_AXIS.get(arch, set())
    with capsys.disabled():
        for rpath, where in sorted(listed.items()):
            print(f"\n{arch}: FSDP shards the stacked axis of {rpath} on "
                  f"{len(where)} (config, mesh) pairs, e.g. "
                  f"{sorted(where)[0]}")


@functools.lru_cache(maxsize=None)
def _cache_leaves(arch: str, smoke: bool, batch: int):
    cfg = rconfig(arch, smoke=smoke)
    model = rbuild(cfg)
    params, _ = _shapes(arch, smoke)
    extra = {}
    if cfg.family == "vlm":
        extra["vis"] = jax.ShapeDtypeStruct(
            (batch, cfg.n_vis_tokens, cfg.d_model), jnp.float32)
    if cfg.family == "encdec":
        extra["frames"] = jax.ShapeDtypeStruct(
            (batch, cfg.enc_seq, cfg.d_model), jnp.float32)
    cache = jax.eval_shape(
        lambda p, kw: model.init_cache(p, batch=batch, max_len=64, **kw),
        params, extra)
    return jax.tree_util.tree_flatten_with_path(cache)[0]


@pytest.mark.parametrize("arch", ARCHS)
def test_batch_and_cache_specs_equal_the_reference(arch):
    for smoke in (True, False):
        rcfg, tcfg = rconfig(arch, smoke=smoke), tconfig(arch, smoke=smoke)
        for port, ref in _meshes():
            for gb in (1, 2, 3, 8, 16, 512):
                want = {k: tuple(v) for k, v in
                        rsh.batch_spec(rcfg, ref, gb).items()}
                assert tsh.batch_spec(tcfg, port, gb) == want
            for gb in (1, 2):
                for long_context in (False, True):
                    rleaf = rsh.cache_spec(rcfg, ref, gb, long_context)
                    tleaf = tsh.cache_spec(tcfg, port, gb, long_context)
                    for path, x in _cache_leaves(arch, smoke, gb):
                        assert tleaf(rsh._path_str(path), x) == tuple(
                            rleaf(path, x)), (port, gb, long_context, path)


@pytest.mark.parametrize("arch", ARCHS)
def test_opt_shardings_equal_the_reference(arch, capsys):
    """ZeRO-1 on the reference's stacked leaves: the same moment specs.
    Listed: the leaves whose moment takes a stacked axis there (the
    port's per-layer moment takes its first free own dim instead)."""
    listed = {}
    for smoke in (True, False):
        rcfg = rconfig(arch, smoke=smoke)
        params_shape, leaves = _shapes(arch, smoke)
        for port, ref in _meshes():
            pshard = rsh.params_shardings(params_shape, rcfg, ref)
            tshard = jax.tree_util.tree_map(
                lambda ns: tsh.Sharding(port, tuple(ns.spec)), pshard)
            for zero1 in (False, True):
                want = ropt.opt_shardings(pshard, params_shape, ref,
                                          zero1=zero1)
                got = topt.opt_shardings(tshard, params_shape, port,
                                         zero1=zero1)
                for k in ("mu", "nu"):
                    w = [tuple(s.spec) for s in jax.tree_util.tree_leaves(
                        want[k])]
                    g = [s.spec for s in jax.tree_util.tree_leaves(
                        got[k], is_leaf=lambda x: isinstance(
                            x, tsh.Sharding))]
                    assert g == w, (smoke, port, zero1, k)
                assert got["count"].spec == tuple(want["count"].spec)
                if zero1:
                    # The first free dim of a stacked leaf is its layer
                    # axis: ZeRO-1 takes it wherever |data| divides it.
                    data = port.shape["data"]
                    for (path, shape), spec in zip(leaves, w):
                        stacked = path.split("/")[0] in STACKED
                        if stacked and shape[0] % data == 0 and (
                                shape[0] >= data) and spec[0] is None:
                            pytest.fail(f"{path}: layer axis left free")
                        if stacked and spec[0] == "data":
                            listed.setdefault(path, set()).add(
                                (smoke, port.sizes))
    with capsys.disabled():
        for path, where in sorted(listed.items()):
            print(f"\n{arch}: ZeRO-1 shards the stacked axis of {path}'s "
                  f"moments on {len(where)} (config, mesh) pairs")


# ---------------------------------------------------------------------------
# Spawned ranks
# ---------------------------------------------------------------------------

ADAMW = dict(lr=1e-3, warmup_steps=0, total_steps=10)
STEPS = 2


@functools.lru_cache(maxsize=None)
def _ref_params(arch):
    """The reference's init (PRNGKey(0)) as a numpy tree."""
    cfg = rconfig(arch, smoke=True)
    params = rbuild(cfg).init(jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(lambda x: np.array(x), params)


def _tcfg():
    return tstep.TrainConfig(adamw=topt.AdamWConfig(**ADAMW), zero1=True)


def _dp_case(name, arch, **extra):
    return {"name": name, "arch": arch, "tcfg": _tcfg(), "batch": 8,
            "seq": 16, "steps": STEPS,
            "params": pickle.dumps(_ref_params(arch)), **extra}


def _port_state(arch):
    cfg = tconfig(arch, smoke=True)
    params = convert.from_jax(_ref_params(arch), cfg, "cpu")
    for p in tree.leaves(params):
        p.requires_grad_(True)
    return {"params": params, "opt": topt.init_state(params)}


@functools.lru_cache(maxsize=None)
def _one_process(arch):
    """The port's one-process steps on the global batches: (losses,
    params, state)."""
    cfg = tconfig(arch, smoke=True)
    step, _ = tstep.make_train_step(
        cfg, dataclasses.replace(_tcfg(), zero1=False), "cpu")
    state = _port_state(arch)
    data = SyntheticLM(cfg, batch=8, seq=16, seed=0)
    losses = []
    for i in range(STEPS):
        state, m = step(state, data(i))
        losses.append(float(m["loss"]))
    return losses, [p.detach().clone() for p in tree.leaves(
        state["params"])], state


@functools.lru_cache(maxsize=None)
def _reference(arch):
    """The reference's jitted one-device steps: (losses, param leaves in
    the port's order)."""
    cfg = rconfig(arch, smoke=True)
    tcfg = rstep.TrainConfig(adamw=ropt.AdamWConfig(**ADAMW))
    train_step, _ = rstep.make_train_step(cfg, tcfg)
    params = jax.tree_util.tree_map(jnp.asarray, _ref_params(arch))
    state = {"params": params, "opt": ropt.init_state(params)}
    data = SyntheticLM(tconfig(arch, smoke=True), batch=8, seq=16, seed=0)
    step = jax.jit(train_step)
    losses = []
    for i in range(STEPS):
        state, m = step(state, {k: jnp.asarray(v)
                                for k, v in data(i).items()})
        losses.append(float(m["loss"]))
    as_np = jax.tree_util.tree_map(np.asarray, state["params"])
    ported = convert.from_jax(as_np, tconfig(arch, smoke=True), "cpu")
    return losses, tree.leaves(ported)


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("four_ranks")
    rng = np.random.default_rng(0)
    b, hq, hkv, s, d = 2, 8, 2, 512, 64
    inputs = {
        "gs": [rng.standard_normal((4, 2, 13 + i)).astype(np.float32)
               for i in range(5)],
        "g": [rng.standard_normal((4, 64)).astype(np.float32)
              for _ in range(2)],
        "q": rng.standard_normal((b, hq, d)).astype(np.float32),
        "k": rng.standard_normal((b, hkv, s, d)).astype(np.float32),
        "v": rng.standard_normal((b, hkv, s, d)).astype(np.float32),
        "lengths": np.array([500, 300], np.int32),
        "dp": [_dp_case("dp4", "yi-9b")],
    }
    torch.save(inputs, tmp / "inputs.pt")
    return inputs, dist_workers.spawn("collectives", 4, str(tmp))


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("two_ranks")
    # 1 -> 2: a one-process checkpoint after the port's steps.
    elastic_in = str(tmp / "one_process_ckpt")
    ckpt.save(_one_process("yi-9b")[2], elastic_in, step=STEPS)
    inputs = {"dp": [_dp_case("dp2", "yi-9b", elastic_in=elastic_in),
                     _dp_case("olmoe2", "olmoe-1b-7b")]}
    torch.save(inputs, tmp / "inputs.pt")
    return inputs, dist_workers.spawn("dp2", 2, str(tmp))


def test_bucketed_all_reduce_matches_the_reference(four_ranks):
    inputs, outs = four_ranks
    gs = [jnp.asarray(g) for g in inputs["gs"]]
    want = jax.vmap(lambda *g: tuple(rcoll.bucketed_all_reduce(
        list(g), "d", bucket_bytes=256)), axis_name="d")(*gs)
    for r, out in enumerate(outs):
        for got, w in zip(out["bucketed"], want):
            np.testing.assert_allclose(got.numpy(), np.asarray(w[r]),
                                       rtol=1e-5, atol=1e-5)


def test_compressed_all_reduce_matches_the_reference(four_ranks):
    """Two rounds with error feedback: q bitwise (the reference's
    quantize_int8 over every rank's values has the pmax scale), the mean
    and the new error within 1e-6."""
    inputs, outs = four_ranks
    err = jnp.zeros((4, 64), jnp.float32)
    step = jax.vmap(lambda g, e: rcoll.compressed_all_reduce(g, e, "d"),
                    axis_name="d")
    for i, g in enumerate(inputs["g"]):
        g = jnp.asarray(g)
        q_want = np.asarray(rcoll.quantize_int8(g + err)[0])
        mean, err = step(g, err)
        for r, out in enumerate(outs):
            np.testing.assert_array_equal(out[f"q{i}"].numpy(), q_want[r])
            np.testing.assert_allclose(out[f"mean{i}"].numpy(),
                                       np.asarray(mean[r]), rtol=1e-6,
                                       atol=1e-6)
            np.testing.assert_allclose(out[f"err{i}"].numpy(),
                                       np.asarray(err[r]), rtol=1e-6,
                                       atol=1e-6)
    assert float(jnp.abs(err).max()) > 0


def test_sp_decode_matches_the_oracle_and_the_local_partials(four_ranks):
    """At 4 ranks (shard 3 holds no live position of slot 1, length 300):
    within 2e-3 of the oracle on every rank, at one split a shard and at
    four; each shard's merged partials against the reference's
    ``_local_partials``."""
    inputs, outs = four_ranks
    q, k, v = (jnp.asarray(inputs[n]) for n in ("q", "k", "v"))
    lengths = jnp.asarray(inputs["lengths"])
    want = np.asarray(rdec.decode_attention(q, k, v, lengths))
    s_local = k.shape[2] // 4
    scale = q.shape[-1] ** -0.5
    for r, out in enumerate(outs):
        for key in ("sp", "sp_split"):
            np.testing.assert_allclose(out[key].numpy(), want, rtol=2e-3,
                                       atol=2e-3)
        mine = slice(r * s_local, (r + 1) * s_local)
        pw = rsp._local_partials(q, k[:, :, mine], v[:, :, mine], lengths,
                                 r * s_local, scale)
        for key in ("partials", "partials_split"):
            for got, w in zip(out[key], pw):
                np.testing.assert_allclose(got.numpy(), np.asarray(w),
                                           rtol=2e-3, atol=2e-3)
    empty = outs[3]["partials"]
    assert float(empty[1][1].max()) == float(np.float32(-1e30))
    assert float(empty[2][1].abs().max()) == 0.0


# The moments, linear in the reduced gradients, leaf by leaf within this
# share of the leaf's largest |moment| of the one-process step's; a step on
# one rank's rows alone is O(1) off.
MOMENT_TOL = 1e-3


def _check_dp(outs, name, arch, world):
    """Loss and parameters against the one-process and reference steps;
    the gathered moments against the one-process step's; parameters
    bitwise across ranks; each moment block 1/world of the bytes on every
    leaf with a dimension ``world`` divides."""
    losses, params, one = _one_process(arch)
    rlosses, rparams = _reference(arch)
    for k in ("mu", "nu"):
        for (path, a), b in zip(
                tree.leaves_with_paths(outs[0][f"{name}_full"]["opt"][k]),
                tree.leaves(one["opt"][k])):
            err = float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
            assert err <= MOMENT_TOL, (k, tree.path_str(path), err)
    for out in outs:
        got = out[f"{name}_losses"]
        np.testing.assert_allclose(got, losses, rtol=1e-4)
        np.testing.assert_allclose(got, rlosses, rtol=1e-4)
        for a, b, c in zip(out[f"{name}_params"], params, rparams):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=5e-3,
                                       atol=5e-3)
            np.testing.assert_allclose(a.numpy(), c.numpy(), rtol=5e-3,
                                       atol=5e-3)
    for a, b in zip(outs[0][f"{name}_params"], outs[-1][f"{name}_params"]):
        assert torch.equal(a, b)
    for p, *mus in zip(params, *(out[f"{name}_mu"] for out in outs)):
        divisible = any(n % world == 0 and n >= world for n in p.shape)
        for mu in mus:
            assert mu.numel() == (p.numel() // world if divisible
                                  else p.numel()), (p.shape, mu.shape)
    # The ranks' blocks make up the whole moment.
    full = outs[0][f"{name}_full"]
    assert sum(m.numel() for out in outs for m in out[f"{name}_mu"]) == sum(
        m.numel() * (1 if any(n % world == 0 and n >= world
                              for n in m.shape) else world)
        for m in tree.leaves(full["opt"]["mu"]))


def test_dp_zero1_step_at_four_ranks(four_ranks):
    _check_dp(four_ranks[1], "dp4", "yi-9b", 4)


def test_dp_zero1_step_at_two_ranks(two_ranks):
    _check_dp(two_ranks[1], "dp2", "yi-9b", 2)


def test_dp_zero1_moe_aux_loss_at_two_ranks(two_ranks):
    """olmoe: the load-balancing loss reads the all-reduced per-expert
    fractions, so the data-parallel step equals the global batch's."""
    _check_dp(two_ranks[1], "olmoe2", "olmoe-1b-7b", 2)


def test_elastic_restore_two_ranks_to_one(two_ranks):
    """The checkpoint the two ranks wrote (rank 0, gathered) restores at
    one rank, bitwise the gathered state."""
    _, outs = two_ranks
    full = outs[0]["dp2_full"]
    restored, step = ckpt.restore(outs[0]["dp2_ckpt"],
                                  template=_port_state("yi-9b"))
    assert step == STEPS
    for (p, a), (_, b) in zip(tree.leaves_with_paths(restored),
                              tree.leaves_with_paths(full)):
        assert torch.equal(a, b), tree.path_str(p)
    for a, b in zip(outs[0]["dp2_full"]["params"].values(),
                    outs[1]["dp2_full"]["params"].values()):
        for x, y in zip(tree.leaves(a), tree.leaves(b)):
            assert torch.equal(x, y)


def test_elastic_restore_one_rank_to_two(two_ranks):
    """A one-process checkpoint restores at two ranks: each rank's
    moments are its block of the stored ones, its parameters and count
    the whole, bitwise."""
    _, outs = two_ranks
    state = _one_process("yi-9b")[2]
    mesh = tmesh.MeshShape(("data", "model"), (2, 1))
    mu_sh = tstep.state_shardings(tconfig("yi-9b", smoke=True), mesh,
                                  state, zero1=True)["opt"]["mu"]
    for r, out in enumerate(outs):
        step, restored = out["dp2_elastic_in"]
        assert step == STEPS
        for a, b in zip(tree.leaves(restored["params"]),
                        tree.leaves(state["params"])):
            assert torch.equal(a.detach(), b.detach())
        assert torch.equal(restored["opt"]["count"], state["opt"]["count"])
        for k in ("mu", "nu"):
            for (path, got), want, sh in zip(
                    tree.leaves_with_paths(restored["opt"][k]),
                    tree.leaves(state["opt"][k]), tree.leaves(mu_sh)):
                dims = [i for i, s in enumerate(sh.spec) if s == "data"]
                if dims:
                    want = want.chunk(2, dims[0])[r]
                assert torch.equal(got, want), tree.path_str(path)


def test_elastic_restore_across_shardings(tmp_path):
    """``tests/test_train_system.py::test_elastic_restore_across_shardings``
    on the port: save, then restore through the resharding path with no
    shardings (one process), bitwise."""
    state = _port_state("yi-9b")
    d = str(tmp_path / "el")
    ckpt.save(state, d, step=5)
    restored, step = ckpt.restore(d, template=state, shardings=None)
    assert step == 5
    for a, b in zip(tree.leaves(state), tree.leaves(restored)):
        assert torch.equal(a.detach(), b.detach())
