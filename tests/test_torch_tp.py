"""Tensor and expert parallel execution over ``model`` (the port's
``distributed.tensor_parallel`` and the split model code) held against the
JAX package's one-device results, the side the reference's two sharded
tests compare with (``tests/test_distributed.py``; they cannot run on this
tree, whose ``jax.make_mesh`` rejects a one-device mesh).

* (a) phi3.5-moe SMOKE on (1, 4) and (2, 2): logits under dense dispatch,
  sorted dispatch, and sorted with capacity drops, against the JAX
  one-device ``model.forward`` at ``test_moe_ep_sharded_forward_matches``'s
  ``rtol=atol=3e-3`` and against the port's one-process forward within
  1e-5 of the largest |logit|.  At (1, 4) a rank holds one query head,
  the replicated K/V head it reads, one expert; at (2, 2) two heads, one
  KV head, two experts.  The kernel route (the kernels' plain versions on
  the CPU) at (1, 4).
* (b) yi-9b SMOKE on (2, 2) with ZeRO-1, ``lr=1e-3``, batch 8 x 16 from
  ``SyntheticLM``, two steps through ``loop.run``: losses against
  ``repro.train.step``'s one-device steps at ``rtol=1e-4``, parameters at
  ``rtol=atol=5e-3`` (``test_sharded_train_step_matches_single_device``'s
  tolerances), first moments and grad norms against the port's
  one-process steps.
* (c) minicpm SMOKE (6 heads of 12, tied vocabulary) on (1, 4): the
  head-dim split with RoPE and the vocab-split tied embedding, forward
  and two steps.
* (d) ``optimizer.global_norm`` over a split against the whole norm.
* (e) the (2, 2) checkpoint restored at one process, bitwise, and onto
  (1, 4), each rank its blocks bitwise.
* (f) the recurrent families: mamba2 and zamba2 SMOKE logits on (1, 4)
  and (2, 2) (each rank holding its ``param_spec`` block of every leaf
  and scanning its SSM heads: at (1, 4) a replicated ``in_proj`` beside
  split conv channels, at (2, 2) a split ``in_proj``; in both a rank's
  heads reading one of two B/C groups; zamba2's shared block split by
  heads), mamba2 with 6 SSM heads at (1, 4) (every rank scans every head
  and keeps its ``d_inner`` rows), with a replicated conv and with a
  ``d_inner`` that does not divide (the block whole after the gathers);
  the kernel route once each; a ZeRO-1 train step of mamba2 on (2, 2)
  and of zamba2 on (1, 4); mamba2's gathered checkpoint restored at one
  process; the rule's picks and a rank's blocks at full width.  Their
  split cache: (h).
* (g) the source families: whisper SMOKE logits on (1, 4) and (2, 2)
  (heads split; the encoder's bidirectional attention and the decoder's
  self-attention unrotated, cross-attention over the encoder states), and
  with 6 heads of 16 at (1, 4) (the ``dh`` split with a source); the VLM
  SMOKE (replicated K/V at (1, 4), KV heads split at (2, 2), the
  column-split ``vis_proj`` gathered); the kernel route once each; a
  ZeRO-1 train step of whisper on (2, 2) and of the VLM on (1, 4), and
  whisper's gathered checkpoint restored at one process.  Their split
  cache: (h).
* Each rank's ``init`` keeps exactly its ``param_spec`` block of the
  one-process ``init``'s leaves, bitwise.
* (h) the split cache of every family: qwen2.5-32b, yi-9b, olmoe,
  mamba2, zamba2, whisper and VLM SMOKE on (1, 4) and (2, 2), each rank
  holding its ``cache_spec`` block of every leaf (its batch rows; the
  self K/V's block of the sequence, every KV head; the SSM state's heads
  and the conv window's channels; the cross K/V's KV heads, replicated
  at (1, 4) for the VLM; the projected vision tokens' rows):
  ``prefill`` of a ragged prompt that crosses the ranks' sequence blocks
  and 4 greedy ``decode_step``s, and a prompt whose decode steps run
  past the cache into every rank's sink where there is a K/V, against
  the port's one process (fp32 logits within 1e-5 of the largest
  |logit| at every step, greedy tokens equal); the mamba2 variants and
  whisper's ``dh`` split at (1, 4); mamba2 and zamba2 with
  ``long_context`` (one sequence over ``data``, zamba2's KV heads over
  ``model``) on (2, 2) and (4, 1); the ``pallas_gather`` route (the
  decode kernel's plain partials on a rank's block, flash and the dense
  decode kernel over a rank's cross K/V, the SSD scan on a rank's heads)
  once a family; the new families' cases also against the JAX
  one-device ``prefill``/``decode_step`` (fp32, 2e-3); the paged layout
  refused by name.
* (i) the trainer's ``("pod", "data")`` batch axes: yi-9b SMOKE on a
  (2, 2, 1) ``(pod, data, model)`` mesh, two ZeRO-1 steps against the
  port's one process.
* (j) FSDP over ``data`` (``distributed.fsdp``) on widened SMOKEs
  (``FSDP_VARIANTS``: the SMOKE widths put every leaf under
  ``_add_fsdp``'s 1 MiB line, these put the MLP or expert leaves and the
  embedding over it and the attention leaves under it): two ZeRO-1 steps
  of the dense variant on (2, 2), on (4, 1), on (pod, data, model) =
  (2, 2, 1) and with ``microbatch`` 2, of the MoE and the VLM variants on
  (2, 2), each against the reference's one-device steps, equal on every
  rank, each rank holding its FSDP blocks of the parameters and moments;
  each rank's FSDP ``init``; the kernel route's forward; the FSDP norm;
  the gathered (2, 2) checkpoint restored at one process and onto (1, 4)
  without FSDP, bitwise; the cache entry points and the families without
  FSDP refused by name.

Every multi-rank case runs in one spawn of four ranks for the whole file
(``tests/dist_workers.py``: JAX-free ranks, a ``file://`` store under tmp,
no fixed port)."""
import dataclasses
import functools
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import dist_workers  # noqa: E402
from repro.models import build_model as rbuild  # noqa: E402
from repro.models import get_config as rconfig  # noqa: E402
from repro.train import optimizer as ropt  # noqa: E402
from repro.train import step as rstep  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.data.pipeline import SyntheticLM  # noqa: E402
from repro_torch.distributed import sharding as tsh  # noqa: E402
from repro_torch.launch.mesh import MeshShape  # noqa: E402
from repro_torch.models import build_model as tbuild  # noqa: E402
from repro_torch.models import get_config as tconfig  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402
from repro_torch.utils import tree  # noqa: E402

torch.set_num_threads(1)
PHI, YI, MINI = "phi3.5-moe-42b-a6.6b", "yi-9b", "minicpm-2b"
WH, VLM = "whisper-small", "llama-3.2-vision-90b"
MB, ZB = "mamba2-1.3b", "zamba2-2.7b"
QWEN, OLMOE = "qwen2.5-32b", "olmoe-1b-7b"
# whisper with 6 heads of 16: over 4 ranks the heads do not divide, so
# attention splits ``dh`` (whisper-small's own split at 8 ranks and more).
WH_DH = "whisper-small/dh"
# mamba2 with d_model 48: 6 SSM heads of 16 do not divide over 4 ranks
# (``d_inner`` 96 does, so ``norm_w`` and ``out_proj`` split in rows of
# 24 across heads); ``in_proj``'s 262 columns stay whole beside a split
# conv (the SMOKE's 328 columns split at 4 and at 2).
MB_HEADS = "mamba2-1.3b/heads"
# mamba2 with one group of state 3: the 134 conv channels stay whole at 4.
MB_CONV = "mamba2-1.3b/conv"
# mamba2 with d_model 45, 6 SSM heads of 15, one group of state 3:
# ``d_inner`` 90 does not divide over 4 ranks, so ``norm_w`` and
# ``out_proj`` stay whole beside a split ``in_proj`` (192 columns) and a
# split conv (96 channels).
MB_ROWS = "mamba2-1.3b/rows"
SSM_VARIANTS = {MB_HEADS: (MB, {"d_model": 48}),
                MB_CONV: (MB, {"ssm_state": 3, "ssm_groups": 1}),
                MB_ROWS: (MB, {"d_model": 45, "ssm_headdim": 15,
                               "ssm_state": 3, "ssm_groups": 1})}
# FSDP: the dense and VLM SMOKEs with d_ff and vocab 8192 (their MLP and
# embedding leaves 524288 elements: over ``_add_fsdp``'s 1 MiB line, the
# attention leaves under it), the MoE SMOKE with d_ff 512 (its expert
# leaves 2 x 8 x 64 x 512 stacked).
YI_W, OLMOE_W = "yi-9b/wide", "olmoe-1b-7b/wide"
VLM_W = "llama-3.2-vision-90b/wide"
FSDP_VARIANTS = {YI_W: (YI, {"d_ff": 8192, "vocab": 8192}),
                 OLMOE_W: (OLMOE, {"d_ff": 512, "vocab": 8192}),
                 VLM_W: (VLM, {"d_ff": 8192, "vocab": 8192})}
VARIANTS = {WH_DH: (WH, {"n_heads": 6, "n_kv_heads": 6}), **SSM_VARIANTS,
            **FSDP_VARIANTS}
# The FSDP train cases: variant, mesh ((data, model), or "pod" for
# (pod, data, model) = (2, 2, 1)) and the TrainConfig fields replaced.
FSDP_TRAIN = {
    "fsdp_yi_22": dict(variant=YI_W, mesh=(2, 2), over={}),
    "fsdp_yi_41": dict(variant=YI_W, mesh=(4, 1), over={}),
    "fsdp_yi_pod": dict(variant=YI_W, mesh="pod", over={}),
    "fsdp_yi_mb2": dict(variant=YI_W, mesh=(2, 2), over={"microbatch": 2}),
    "fsdp_olmoe_22": dict(variant=OLMOE_W, mesh=(2, 2), over={}),
    "fsdp_vlm_22": dict(variant=VLM_W, mesh=(2, 2), over={}),
}
SHAPES = [(1, 4), (2, 2)]
ADAMW = dict(lr=1e-3, warmup_steps=0, total_steps=10)
STEPS = 2
# The reference's own tolerances (tests/test_distributed.py).
EP_TOL = dict(rtol=3e-3, atol=3e-3)
LOSS_RTOL, PARAM_TOL = 1e-4, dict(rtol=5e-3, atol=5e-3)
# Split against one process, both torch: a share of the largest |logit|.
ONE_PROCESS_TOL = 1e-5
# The moments, linear in the gradients, leaf by leaf within this share of
# the leaf's largest |moment| of the one-process steps.
MOMENT_TOL = 1e-3
PHI_CASES = {
    "dense": {"cfg": {}, "toks": "phi_toks"},
    "sorted": {"cfg": {"moe_dispatch": "sorted"}, "toks": "phi_toks"},
    # 512 (token, choice) pairs into 4 experts of capacity 128: drops.
    "drops": {"cfg": {"moe_dispatch": "sorted", "capacity_factor": 0.5},
              "toks": "phi_drop_toks"},
}


def _rcfg(name):
    """The reference's SMOKE config of ``name`` (an arch or a variant)."""
    arch, over = VARIANTS.get(name, (name, {}))
    return dataclasses.replace(rconfig(arch, smoke=True), **over)


def _pcfg(name):
    """The port's SMOKE config of ``name``."""
    arch, over = VARIANTS.get(name, (name, {}))
    return dataclasses.replace(tconfig(arch, smoke=True), **over)


@functools.lru_cache(maxsize=None)
def _ref_params(name):
    """The reference's init (PRNGKey(0)) as a numpy tree."""
    params = rbuild(_rcfg(name)).init(jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(lambda x: np.array(x), params)


def _tcfg(zero1=True):
    return tstep.TrainConfig(adamw=topt.AdamWConfig(**ADAMW), zero1=zero1)


def _inputs():
    rng = np.random.default_rng(0)
    vocab = tconfig(PHI, smoke=True).vocab
    wh, vlm = tconfig(WH, smoke=True), tconfig(VLM, smoke=True)
    return {
        "params": {a: pickle.dumps(_ref_params(a))
                   for a in (PHI, YI, MINI, WH, WH_DH, VLM, MB, ZB,
                             *SSM_VARIANTS, QWEN, OLMOE, *FSDP_VARIANTS)},
        # The reference test's tokens (PRNGKey(1), 4 x 16).
        "phi_toks": np.asarray(jax.random.randint(
            jax.random.PRNGKey(1), (4, 16), 0, vocab), np.int32),
        "phi_drop_toks": rng.integers(0, vocab, (4, 64)).astype(np.int32),
        "mini_toks": rng.integers(0, vocab, (4, 16)).astype(np.int32),
        "phi_cases": PHI_CASES,
        "train": {"tcfg": _tcfg(), "batch": 8, "seq": 16, "steps": STEPS},
        "norm_leaves": [rng.standard_normal(tuple(p.shape)).astype(
            np.float32) for p in tree.leaves(_one_process_params(YI))],
        # Drawn after the cases above, which keep their inputs.
        "wh_dh_over": VARIANTS[WH_DH][1],
        "wh_toks": rng.integers(0, wh.vocab, (4, 16)).astype(np.int32),
        "wh_frames": rng.standard_normal((4, wh.enc_seq, wh.d_model)
                                         ).astype(np.float32),
        "vlm_toks": rng.integers(0, vlm.vocab, (4, 16)).astype(np.int32),
        "vlm_vis": rng.standard_normal((4, vlm.n_vis_tokens, vlm.d_model)
                                       ).astype(np.float32),
        "ssm_toks": rng.integers(0, tconfig(MB, smoke=True).vocab,
                                 (4, 16)).astype(np.int32),
        "ssm_variants": SSM_VARIANTS,
        "split_serve": _split_cases(),
        **_fsdp_inputs(),
    }


@functools.lru_cache(maxsize=None)
def _fsdp_inputs():
    rng = np.random.default_rng(32)
    toks = rng.integers(0, _pcfg(YI_W).vocab, (4, 16)).astype(np.int32)
    return {"fsdp_toks": toks, "fsdp": {
        "variants": FSDP_VARIANTS, "train": FSDP_TRAIN, "reshard":
        "fsdp_yi_22", "forward": {"variant": YI_W, "toks": toks},
        "norm_leaves": [rng.standard_normal(tuple(p.shape)).astype(
            np.float32) for p in tree.leaves(_one_process_params(YI_W))]}}


# The split cache cases (``arch`` an arch or a variant): ``max_len`` 32
# puts 8 positions in a rank's sequence block at (1, 4) and 16 at (2, 2),
# so the 12-token prompt (12, 5, 9 and 7 of its tokens valid) crosses
# blocks; ``max_len`` 16 with a 14-token prompt sends the third and fourth
# decode steps' K/V past the cache, into every rank's sink.  ``long``: one
# sequence (20 of a 24-token block valid) over ``data``, 16 positions a
# rank at (2, 2) and 8 at (4, 1).
RAGGED, FULL = dict(max_len=32, seg=[12, 5, 9, 7]), dict(max_len=16,
                                                          seg=[14] * 4)
LONG = dict(max_len=32, seg=[20], block=24, long=True,
            meshes=[(2, 2), (4, 1)])
SPLIT_CASES = {
    **{f"{a}/cross": dict(arch=a, **RAGGED)
       for a in (QWEN, YI, OLMOE, MB, ZB, WH, VLM)},
    **{f"{a}/overflow": dict(arch=a, **FULL)
       for a in (YI, OLMOE, ZB, WH, VLM)},
    f"{YI}/pallas_gather": dict(arch=YI, **RAGGED, kernel="pallas_gather",
                                meshes=[(1, 4)]),
    **{f"{a}/pallas_gather": dict(arch=a, **RAGGED, kernel="pallas_gather",
                                  meshes=[shape])
       for a, shape in ((MB, (2, 2)), (ZB, (1, 4)), (WH, (1, 4)),
                        (VLM, (2, 2)))},
    **{f"{v}/cross": dict(arch=v, **RAGGED, meshes=[(1, 4)])
       for v in (*SSM_VARIANTS, WH_DH)},
    **{f"{a}/long": dict(arch=a, **LONG) for a in (MB, ZB)},
    f"{ZB}/long_overflow": dict(arch=ZB, **dict(LONG, max_len=16,
                                                seg=[14], block=14)),
    f"{ZB}/long_pallas_gather": dict(arch=ZB, **dict(
        LONG, kernel="pallas_gather", meshes=[(2, 2)])),
}
SPLIT_STEPS = 4
# The families whose split cache this file also holds against the JAX
# package's one-device steps (the dense and MoE ones have
# ``tests/test_torch_serve.py``'s and ``test_torch_moe.py``'s).
JAX_SPLIT_FAMILIES = ("ssm", "hybrid", "encdec", "vlm")
JAX_TOL = dict(rtol=2e-3, atol=2e-3)


@functools.lru_cache(maxsize=None)
def _split_cases():
    rng = np.random.default_rng(31)
    out = {}
    for name, case in SPLIT_CASES.items():
        cfg = _pcfg(case["arch"])
        b = len(case["seg"])
        src = {}
        if cfg.family == "encdec":
            src["frames"] = rng.standard_normal(
                (b, cfg.enc_seq, cfg.d_model)).astype(np.float32)
        if cfg.family == "vlm":
            src["vis"] = rng.standard_normal(
                (b, cfg.n_vis_tokens, cfg.d_model)).astype(np.float32)
        s = case.get("block", max(case["seg"]))
        out[name] = {**case, "meshes": case.get("meshes", SHAPES),
                     "steps": SPLIT_STEPS, "src": src,
                     "variant": VARIANTS.get(case["arch"],
                                             (case["arch"], {})),
                     "params": case["arch"],
                     "toks": rng.integers(0, cfg.vocab, (b, s)).astype(
                         np.int32),
                     "seg_lens": np.asarray(case["seg"], np.int32)}
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp_ranks")
    inputs = _inputs()
    torch.save(inputs, tmp / "inputs.pt")
    return inputs, dist_workers.spawn("tp", 4, str(tmp))


class _At:
    """A mesh seen from one coordinate: what ``sharding.shard`` reads."""
    mesh_dim_names = ("data", "model")

    def __init__(self, shape, coord):
        self.shape, self.coord = shape, coord

    def get_coordinate(self):
        return list(self.coord)


def _blocks(params, cfg, shape, coord, fsdp=False):
    """Rank ``coord``'s block of every leaf of a whole tree (``fsdp``: under
    the FSDP rule)."""
    shs = tsh.params_shardings(params, cfg, MeshShape(("data", "model"),
                                                      shape), fsdp=fsdp)
    return [tsh.shard(p, tsh.Sharding(_At(shape, coord), s.spec))
            for p, s in zip(tree.leaves(params), tree.leaves(shs))]


def _one_process_params(name):
    return convert.from_jax(_ref_params(name), _pcfg(name), "cpu")


def _check_logits(outs, key, shape, arch, toks_key, over=(),
                  kernel="xla", src_key=None):
    """Each rank's logits (its ``data`` rows of the tokens, and of the
    source ``src_key`` where given: a batch of its own, so sorted
    dispatch's capacity counts its tokens, as in the data-parallel
    trainer) against the JAX one-device forward and the port's one
    process on those rows."""
    for out in outs:
        i = out["coords"][shape][0]
        want_jax, want_port = _forwards(arch, toks_key, over, kernel,
                                        (i, shape[0]), src_key)
        got = out[key].numpy()
        np.testing.assert_allclose(got, want_jax, **EP_TOL)
        err = float(np.abs(got - want_port).max())
        scale = float(np.abs(want_port).max())
        assert err <= ONE_PROCESS_TOL * scale, (key, err, scale)


@functools.lru_cache(maxsize=None)
def _forwards(arch, toks_key, over=(), kernel="xla", part=(0, 1),
              src_key=None):
    """(JAX one-device logits, the port's one-process logits) on part
    ``i`` of ``n`` of the tokens' rows (and the source's)."""
    inputs = _inputs()
    i, n = part
    rows = slice(i * len(inputs[toks_key]) // n,
                 (i + 1) * len(inputs[toks_key]) // n)
    toks = inputs[toks_key][rows]
    rcfg = dataclasses.replace(_rcfg(arch), **dict(over))
    key = "frames" if rcfg.family == "encdec" else "vis"
    src = {} if src_key is None else {key: inputs[src_key][rows]}
    want, _ = rbuild(rcfg).forward(
        jax.tree_util.tree_map(jnp.asarray, _ref_params(arch)),
        jnp.asarray(toks), **{k: jnp.asarray(v) for k, v in src.items()})
    cfg = dataclasses.replace(_pcfg(arch), decode_kernel=kernel,
                              **dict(over))
    with torch.no_grad():
        port, _ = tbuild(cfg, "cpu").forward(
            _one_process_params(arch), torch.from_numpy(toks.copy()),
            **{k: torch.from_numpy(v.copy()) for k, v in src.items()})
    return np.asarray(want, np.float32), port.numpy()


@pytest.mark.parametrize("arch", [YI, PHI, MINI, WH, VLM, MB, ZB])
@pytest.mark.parametrize("shape", SHAPES)
def test_init_keeps_the_param_spec_blocks(ranks, arch, shape):
    """Each rank's ``init`` from the one-process seed keeps exactly its
    ``param_spec`` block of every leaf, bitwise."""
    cfg = tconfig(arch, smoke=True)
    whole = tbuild(cfg, "cpu").init(torch.Generator().manual_seed(7))
    for out in ranks[1]:
        got = tree.leaves(out[f"init_{arch}_{shape}"])
        want = _blocks(whole, cfg, shape, out["coords"][shape])
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert a.shape == b.shape and torch.equal(a, b)
    split = sum(a.numel() < b.numel() for a, b in zip(
        tree.leaves(ranks[1][0][f"init_{arch}_{shape}"]),
        tree.leaves(whole)))
    assert split > 0


@pytest.mark.parametrize("case", list(PHI_CASES))
@pytest.mark.parametrize("shape", SHAPES)
def test_moe_ep_forward_matches_the_reference(ranks, case, shape):
    """(a) ``test_moe_ep_sharded_forward_matches`` answered by the port:
    the split forward's logits (each rank its ``data`` rows) against the
    JAX one-device forward and the port's one process."""
    over = tuple(sorted(PHI_CASES[case]["cfg"].items()))
    _check_logits(ranks[1], f"phi_{case}_{shape}", shape, PHI,
                  PHI_CASES[case]["toks"], over)


def test_moe_ep_forward_on_the_kernel_route(ranks):
    """phi3.5-moe on (1, 4) through the kernel route's wrappers (flash,
    fused norm and the grouped GEMM at each rank's local shapes; their
    plain versions on the CPU)."""
    _check_logits(ranks[1], "phi_kernel_route", (1, 4), PHI, "phi_toks",
                  kernel="pallas_paged")


def test_head_dim_split_forward_matches_the_reference(ranks):
    """(c) minicpm on (1, 4): 6 heads do not divide over 4 ranks, so q, k,
    v and ``wo`` split ``dh`` (12 -> 3), gathered before RoPE; the tied
    ``tok`` is split by vocab rows for the embedding and the logits."""
    assert tsh._attn_dims(tconfig(MINI, smoke=True), 6, 4) == (None, "model")
    _check_logits(ranks[1], "minicpm_logits", (1, 4), MINI, "mini_toks")


def _port_state(arch):
    params = _one_process_params(arch)
    for p in tree.leaves(params):
        p.requires_grad_(True)
    return {"params": params, "opt": topt.init_state(params)}


@functools.lru_cache(maxsize=None)
def _one_process(arch):
    """The port's one-process steps: (losses, grad norms, final state)."""
    cfg = _pcfg(arch)
    step, _ = tstep.make_train_step(cfg, _tcfg(zero1=False), "cpu")
    state = _port_state(arch)
    data = SyntheticLM(cfg, batch=8, seq=16, seed=0)
    losses, norms = [], []
    for i in range(STEPS):
        state, m = step(state, data(i))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return losses, norms, state


@functools.lru_cache(maxsize=None)
def _reference(arch):
    """The reference's jitted one-device steps: (losses, param leaves in
    the port's order)."""
    cfg = _rcfg(arch)
    train_step, _ = rstep.make_train_step(
        cfg, rstep.TrainConfig(adamw=ropt.AdamWConfig(**ADAMW)))
    params = jax.tree_util.tree_map(jnp.asarray, _ref_params(arch))
    state = {"params": params, "opt": ropt.init_state(params)}
    data = SyntheticLM(_pcfg(arch), batch=8, seq=16, seed=0)
    step = jax.jit(train_step)
    losses = []
    for i in range(STEPS):
        state, m = step(state, {k: jnp.asarray(v)
                                for k, v in data(i).items()})
        losses.append(float(m["loss"]))
    as_np = jax.tree_util.tree_map(np.asarray, state["params"])
    return losses, tree.leaves(convert.from_jax(as_np, _pcfg(arch), "cpu"))


def _check_train(outs, name, arch):
    losses, norms, one = _one_process(arch)
    rlosses, rparams = _reference(arch)
    for out in outs:
        got = out[f"{name}_losses"]
        assert got == outs[0][f"{name}_losses"]       # equal across ranks
        np.testing.assert_allclose(got, rlosses, rtol=LOSS_RTOL)
        np.testing.assert_allclose(got, losses, rtol=LOSS_RTOL)
        np.testing.assert_allclose(out[f"{name}_norms"], norms, rtol=1e-5)
    full = outs[0][f"{name}_full"]
    for a, b, c in zip(tree.leaves(full["params"]),
                       tree.leaves(one["params"]), rparams):
        np.testing.assert_allclose(a.numpy(), c.numpy(), **PARAM_TOL)
        np.testing.assert_allclose(a.numpy(), b.detach().numpy(),
                                   **PARAM_TOL)
    for k in ("mu", "nu"):
        for (path, a), b in zip(tree.leaves_with_paths(full["opt"][k]),
                                tree.leaves(one["opt"][k])):
            err = float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
            assert err <= MOMENT_TOL, (k, tree.path_str(path), err)
    for out in outs[1:]:
        for a, b in zip(tree.leaves(out[f"{name}_full"]), tree.leaves(full)):
            assert torch.equal(a, b)


def test_sharded_train_step_matches_the_reference(ranks):
    """(b) ``test_sharded_train_step_matches_single_device`` answered by
    the port: yi-9b on (2, 2) with ZeRO-1 (2 query heads, 1 KV head,
    ``d_ff`` 88 and 128 vocab rows a rank)."""
    _check_train(ranks[1], "yi", YI)


def test_head_dim_split_train_step(ranks):
    """(c) minicpm on (1, 4): the head-dim split and the vocab-parallel
    loss over the tied embedding, two steps."""
    _check_train(ranks[1], "minicpm", MINI)


def test_split_global_norm(ranks):
    """(d) the norm of this rank's blocks with the split leaves' squares
    summed over ``model`` is the whole tree's norm on every rank."""
    inputs, outs = ranks
    want = float(topt.global_norm([torch.from_numpy(g)
                                   for g in inputs["norm_leaves"]]))
    for out in outs:
        assert abs(out["norm"] - want) <= 1e-6 * want, (out["norm"], want)


def test_checkpoint_restores_at_one_process(ranks):
    """(e) the checkpoint the (2, 2) ranks wrote (gathered, rank 0)
    restores at one process, bitwise the gathered state."""
    outs = ranks[1]
    restored, step = ckpt.restore(outs[0]["yi_ckpt"],
                                  template=_port_state(YI))
    assert step == STEPS
    for (p, a), b in zip(tree.leaves_with_paths(restored),
                         tree.leaves(outs[0]["yi_full"])):
        assert torch.equal(a.detach(), b), tree.path_str(p)


def test_checkpoint_reshards_onto_another_mesh(ranks):
    """(e) the (2, 2) checkpoint restored onto (1, 4): each rank holds its
    blocks of the gathered state, bitwise (moments: the ``model`` blocks,
    ``data`` being 1)."""
    outs = ranks[1]
    full = outs[0]["yi_full"]
    shs = tstep.state_shardings(tconfig(YI, smoke=True),
                                MeshShape(("data", "model"), (1, 4)),
                                zero1=True)
    for out in outs:
        step, restored = out["yi_restored_14"]
        assert step == STEPS
        at = _At((1, 4), out["coords"][(1, 4)])
        for (p, got), want, s in zip(tree.leaves_with_paths(restored),
                                     tree.leaves(full), tree.leaves(shs)):
            want = tsh.shard(want, tsh.Sharding(at, s.spec))
            assert torch.equal(got.detach(), want), tree.path_str(p)


def test_split_model_refuses_serving(ranks):
    """The split dense model refuses the paged cache layout by name:
    paged serving stays on one rank (``ServeEngine`` takes no mesh, as
    the reference's)."""
    assert all(out.get("serve_refused") for out in ranks[1])


@functools.lru_cache(maxsize=None)
def _one_process_serve(name):
    """The port's one-process prefill and greedy decode steps of a split
    case on the whole batch: each step's logits."""
    case = _split_cases()[name]
    cfg = dataclasses.replace(_pcfg(case["arch"]),
                              decode_kernel=case.get("kernel", "xla"))
    model = tbuild(cfg, "cpu")
    params = _one_process_params(case["arch"])
    src = {k: torch.from_numpy(v.copy()) for k, v in case["src"].items()}
    out = []
    with torch.no_grad():
        cache = model.init_cache(params, batch=len(case["toks"]),
                                 max_len=case["max_len"], **src)
        logits, cache = model.prefill(
            params, cache, torch.from_numpy(case["toks"].copy()),
            seg_lens=torch.from_numpy(case["seg_lens"].copy()))
        out.append(logits)
        for _ in range(case["steps"]):
            logits, cache = model.decode_step(
                params, cache, logits.argmax(-1).to(torch.int32))
            out.append(logits)
    return out


@functools.lru_cache(maxsize=None)
def _jax_steps(arch):
    """The reference model of ``arch`` (an arch or a variant) and its
    jitted ``prefill`` and ``decode_step``, shared by the cases of one
    shape."""
    model = rbuild(_rcfg(arch))
    return model, jax.jit(model.prefill), jax.jit(model.decode_step)


@functools.lru_cache(maxsize=None)
def _jax_serve(name):
    """The JAX package's one-device ``prefill`` and ``decode_step`` of a
    split case on the whole batch (jitted), each decode step fed the
    port's one-process greedy tokens: each step's logits."""
    case = _split_cases()[name]
    model, prefill, step = _jax_steps(case["arch"])
    params = jax.tree_util.tree_map(jnp.asarray, _ref_params(case["arch"]))
    src = {k: jnp.asarray(v) for k, v in case["src"].items()}
    cache = model.init_cache(params, batch=len(case["toks"]),
                             max_len=case["max_len"], **src)
    logits, cache = prefill(params, cache, jnp.asarray(case["toks"]),
                            seg_lens=jnp.asarray(case["seg_lens"]))
    out = [np.asarray(logits)]
    for want in _one_process_serve(name)[:-1]:
        logits, cache = step(params, cache, jnp.asarray(
            want.argmax(-1).to(torch.int32).numpy()))
        out.append(np.asarray(logits))
    return out


def _reference_blocks(name, shape):
    """Each cache leaf's block a rank holds: the reference's
    ``cache_spec`` on a device-free mesh of ``shape`` over the one-device
    cache's leaves (the port's self K/V rings add their sink position;
    its cursors are its batch rows)."""
    from jax.sharding import AbstractMesh

    from repro.distributed import sharding as rsh

    case = _split_cases()[name]
    rcfg = _rcfg(case["arch"])
    b = len(case["toks"])
    mesh = AbstractMesh(shape, ("data", "model"))
    sizes = dict(zip(("data", "model"), shape))
    src = {k: jax.ShapeDtypeStruct(v.shape, jnp.float32)
           for k, v in case["src"].items()}
    params = jax.eval_shape(rbuild(rcfg).init, jax.random.PRNGKey(0))
    cache = jax.eval_shape(
        lambda p, kw: rbuild(rcfg).init_cache(
            p, batch=b, max_len=case["max_len"], **kw), params, src)
    spec_of = rsh.cache_spec(rcfg, mesh, b,
                             long_context=bool(case.get("long")))
    rows = b // sizes["data"] if b % sizes["data"] == 0 else b
    out = {}
    for path, x in jax.tree_util.tree_flatten_with_path(cache)[0]:
        p = rsh._path_str(path)
        if p == "lengths":
            out[p] = (rows,)
            continue
        block = list(x.shape)
        for dim, part in enumerate(spec_of(path, x)):
            for axis in ((part,) if isinstance(part, str) else part or ()):
                block[dim] //= sizes[axis]
        if (p.endswith("/k") or p.endswith("/v")) and "cross" not in p:
            block[-3] += 1                              # the sink
        out[p] = tuple(block)
    return out


SPLIT_PAIRS = [(name, shape) for name, case in SPLIT_CASES.items()
               for shape in case.get("meshes", SHAPES)]


@pytest.mark.parametrize("name, shape", SPLIT_PAIRS)
def test_split_cache_prefill_and_decode_match_one_process(ranks, name,
                                                          shape):
    """(h) each rank's rows of the split prefill and decode steps against
    the one process's: within 1e-5 of the largest |logit| at every step,
    greedy tokens equal; each rank holds the reference's ``cache_spec``
    block of every leaf plus a sink position on its self K/V."""
    want = _one_process_serve(name)
    blocks = _reference_blocks(name, shape)
    for out in ranks[1]:
        got = out[f"split_{name}_{shape}"]
        rows = slice(*got["rows"])
        assert got["blocks"] == blocks, (name, got["blocks"], blocks)
        for step, (a, b) in enumerate(zip(got["logits"], want)):
            b = b[rows]
            err = float((a - b).abs().max())
            scale = float(b.abs().max())
            assert err <= ONE_PROCESS_TOL * scale, (name, step, err, scale)
            assert torch.equal(a.argmax(-1), b.argmax(-1)), (name, step)


@pytest.mark.parametrize("name, shape", [
    (name, shape) for name, shape in SPLIT_PAIRS
    if _pcfg(SPLIT_CASES[name]["arch"]).family in JAX_SPLIT_FAMILIES])
def test_split_cache_matches_the_jax_one_device_steps(ranks, name, shape):
    """(h) each rank's rows of the split steps of the mamba2, zamba2,
    whisper and VLM cases against the JAX package's one-device
    ``prefill``/``decode_step`` on the same weights, fp32 within 2e-3."""
    want = _jax_serve(name)
    assert len(want) == 1 + SPLIT_STEPS
    for out in ranks[1]:
        got = out[f"split_{name}_{shape}"]
        rows = slice(*got["rows"])
        for a, b in zip(got["logits"], want):
            np.testing.assert_allclose(a.numpy(), b[rows], **JAX_TOL)


def test_pod_data_train_step_matches_one_process(ranks):
    """(i) yi-9b on (pod, data, model) = (2, 2, 1), the batch over the
    flattened pod x data ranks (two rows each), ZeRO-1 moments over
    ``data``: the losses and parameters of two steps against the port's
    one process, equal on every rank."""
    losses, _, one = _one_process(YI)
    outs = ranks[1]
    assert sorted(out["pod_coord"] for out in outs) == [
        (0, 0, 0), (0, 1, 0), (1, 0, 0), (1, 1, 0)]
    for out in outs:
        assert out["pod_losses"] == outs[0]["pod_losses"]
        np.testing.assert_allclose(out["pod_losses"], losses, rtol=1e-5)
        for a, b in zip(out["pod_params"], tree.leaves(one["params"])):
            np.testing.assert_allclose(a.numpy(), b.detach().numpy(),
                                       **PARAM_TOL)
        for a, b in zip(out["pod_params"], outs[0]["pod_params"]):
            assert torch.equal(a, b)


def test_collectives_are_clocked(ranks):
    """``tensor_parallel.CLOCK`` on: the forward's collectives add host
    time."""
    for out in ranks[1]:
        assert out["clock_s"] > 0


@pytest.mark.parametrize("shape", SHAPES)
def test_whisper_forward_matches_the_reference(ranks, shape):
    """(g) whisper SMOKE, 4 heads of 16: one head a rank at (1, 4), two
    at (2, 2).  The encoder's self-attention is bidirectional and neither
    self-attention is rotated; each decoder layer's cross-attention
    projects the encoder states (whole on every rank, entered through a
    *copy*) on this rank's heads."""
    assert tsh._attn_dims(_pcfg(WH), 4, shape[1]) == ("model", None)
    _check_logits(ranks[1], f"whisper_{shape}", shape, WH, "wh_toks",
                  src_key="wh_frames")


def test_whisper_head_dim_split_with_a_source(ranks):
    """(g) whisper with 6 heads of 16 at (1, 4): q, k and v split ``dh``
    (16 -> 4) and are gathered over it, k and v projecting the encoder
    states in the cross layers, no RoPE anywhere."""
    cfg = _pcfg(WH_DH)
    assert tsh._attn_dims(cfg, cfg.n_heads, 4) == (None, "model")
    assert tsh._kv_dims(cfg, 4) == (None, "model")
    _check_logits(ranks[1], "whisper_dh", (1, 4), WH_DH, "wh_toks",
                  src_key="wh_frames")


@pytest.mark.parametrize("shape", SHAPES)
def test_vlm_forward_matches_the_reference(ranks, shape):
    """(g) the VLM SMOKE (4 query heads, 2 KV heads): at (1, 4) the K/V
    are replicated and each rank projects the KV head its query head
    reads, over the vision tokens in the cross layers; at (2, 2) the KV
    heads split.  ``vis_proj`` is split by output columns and gathered,
    so every rank's cross layers read the whole projected tokens."""
    cfg = _pcfg(VLM)
    assert tsh._kv_dims(cfg, shape[1]) == (
        (None, None) if shape[1] == 4 else ("model", None))
    _check_logits(ranks[1], f"vlm_{shape}", shape, VLM, "vlm_toks",
                  src_key="vlm_vis")


@pytest.mark.parametrize("arch, key, shape, toks, src", [
    (WH, "whisper_kernel_route", (1, 4), "wh_toks", "wh_frames"),
    (VLM, "vlm_kernel_route", (2, 2), "vlm_toks", "vlm_vis")])
def test_source_families_on_the_kernel_route(ranks, arch, key, shape, toks,
                                             src):
    """(g) the kernel route's wrappers at each rank's local shapes (flash
    causal, bidirectional and over a source; the fused LayerNorm and RMS
    norm; their plain versions on the CPU)."""
    _check_logits(ranks[1], key, shape, arch, toks, kernel="pallas_paged",
                  src_key=src)


@pytest.mark.parametrize("arch, name", [(WH, "whisper"), (VLM, "vlm")])
def test_source_family_train_step(ranks, arch, name):
    """(g) two ZeRO-1 steps (whisper on (2, 2): each ``data`` rank its
    rows of the tokens and frames; the VLM on (1, 4)) against the
    reference's one-device steps and the port's one process: losses,
    parameters, moments, grad norms."""
    _check_train(ranks[1], name, arch)


def test_whisper_checkpoint_restores_at_one_process(ranks):
    """(g) whisper's (2, 2) checkpoint (stacked encoder and decoder
    layers, the replicated ``dec_pos``), gathered by rank 0, restores at
    one process bitwise."""
    outs = ranks[1]
    restored, step = ckpt.restore(outs[0]["whisper_ckpt"],
                                  template=_port_state(WH))
    assert step == STEPS
    for (p, a), b in zip(tree.leaves_with_paths(restored),
                         tree.leaves(outs[0]["whisper_full"])):
        assert torch.equal(a.detach(), b), tree.path_str(p)


@pytest.mark.parametrize("arch", [MB, ZB])
@pytest.mark.parametrize("shape", SHAPES)
def test_ssm_forward_matches_the_reference(ranks, arch, shape):
    """(f) mamba2 and zamba2 SMOKE (8 SSM heads of 16 in 2 groups,
    ``in_proj`` 328 columns, 192 conv channels), every leaf split: at
    (1, 4) 82 ``in_proj`` columns (the first two blocks inside z) and 48
    conv channels, a rank scanning 2 heads of one group; at (2, 2) 164
    columns (the first block all of z and 36 columns of x) and 96
    channels, 4 heads of one group a rank.  zamba2's shared block splits
    its 4 heads of 16."""
    _check_logits(ranks[1], f"{arch}_{shape}", shape, arch, "ssm_toks")


@pytest.mark.parametrize("name", list(SSM_VARIANTS))
def test_ssm_variants_at_four_ranks(ranks, name):
    """(f) at (1, 4): mamba2 with 6 SSM heads (every rank scans every
    head, then keeps its 24 rows of ``d_inner`` for the gated norm and
    ``out_proj``), mamba2 with a whole conv (every rank convolves every
    channel), and mamba2 with ``d_inner`` 90 (every rank runs the whole
    block after the split ``in_proj`` and conv, ``out_proj`` whole)."""
    _check_logits(ranks[1], name, (1, 4), name, "ssm_toks")


@pytest.mark.parametrize("arch, shape", [(MB, (2, 2)), (ZB, (1, 4))])
def test_ssm_families_on_the_kernel_route(ranks, arch, shape):
    """(f) the kernel route's wrappers at a rank's shapes (the SSD scan on
    its heads and their groups, the fused norm, zamba2's flash on its
    heads; their plain versions on the CPU)."""
    _check_logits(ranks[1], f"{arch}_kernel_route", shape, arch,
                  "ssm_toks", kernel="pallas_paged")


@pytest.mark.parametrize("arch, name", [(MB, "mamba2"), (ZB, "zamba2"),
                                        (MB_ROWS, "mamba2_rows")])
def test_ssm_family_train_step(ranks, arch, name):
    """(f) two ZeRO-1 steps (mamba2 on (2, 2); zamba2, and mamba2 with
    ``d_inner`` 90, on (1, 4)) against the reference's one-device steps
    and the port's one process.  The moments catch a gradient left
    partial (the norm's statistic, or ``A_log``/``D``/``dt_bias`` read on
    a rank's heads only) or summed twice (a copy in the whole block after
    the gathers)."""
    _check_train(ranks[1], name, arch)


def test_mamba2_checkpoint_restores_at_one_process(ranks):
    """(f) mamba2's (2, 2) checkpoint (split ``in_proj``, conv, ``norm_w``
    and ``out_proj``; replicated ``A_log``, ``D``, ``dt_bias``), gathered
    by rank 0, restores at one process bitwise."""
    outs = ranks[1]
    restored, step = ckpt.restore(outs[0]["mamba2_ckpt"],
                                  template=_port_state(MB))
    assert step == STEPS
    for (p, a), b in zip(tree.leaves_with_paths(restored),
                         tree.leaves(outs[0]["mamba2_full"])):
        assert torch.equal(a.detach(), b), tree.path_str(p)


class _Ranked(_At):
    """A mesh seen from one coordinate, with the rank lookups
    ``ModelParallel`` makes (no process group behind it)."""

    def get_local_rank(self, axis):
        return self.coord[self.mesh_dim_names.index(axis)]

    def get_group(self, axis):
        return None


@pytest.mark.parametrize("name, smoke, shape, want", [
    (MB, False, (1, 4), (True, True, True, True)),
    (ZB, False, (1, 4), (True, True, True, True)),
    (MB, True, (1, 4), (True, True, True, True)),
    (MB, True, (2, 2), (True, True, True, True)),
    (MB, True, (1, 3), (False, True, False, False)),
    (MB_HEADS, True, (1, 4), (False, True, True, False)),
    (MB_CONV, True, (1, 4), (False, False, True, True)),
    (MB_ROWS, True, (1, 4), (True, True, False, False))])
def test_ssm_picks_from_the_rule(name, smoke, shape, want):
    """(f) ``ModelParallel``'s picks (``in_proj`` split, conv split,
    ``d_inner`` split, heads split) for the full-width and SMOKE configs,
    and for ``d_inner`` 128 over 3 ranks (``in_proj``'s 328 columns and
    the rows whole, the 192 conv channels split); the B/C groups a rank's
    heads read (the CONFIGs have one, the SMOKEs two)."""
    from repro_torch.distributed.tensor_parallel import ModelParallel

    arch, over = VARIANTS.get(name, (name, {}))
    cfg = dataclasses.replace(tconfig(arch, smoke=smoke), **over)
    for r in range(shape[1]):
        tp = ModelParallel(cfg, _Ranked(shape, (0, r)))
        assert (tp.in_proj_split, tp.conv_split, tp.ssm_rows_split,
                tp.ssm_heads_split) == want
        if tp.ssm_heads_split:
            hl = cfg.ssm_heads // shape[1]
            per = cfg.ssm_heads // cfg.ssm_groups
            lo = r * hl // per
            assert tp.ssm_groups(hl) == slice(lo, lo + max(1, hl // per))


@pytest.mark.parametrize("arch, blocks", [
    (MB, {"in_proj": (2048, 2128), "conv_w": (4, 1088), "conv_b": (1088,),
          "norm_w": (1024,), "out_proj": (1024, 2048), "A_log": (64,),
          "tok": (12800, 2048)}),
    (ZB, {"in_proj": (2560, 2612), "conv_w": (4, 1312), "norm_w": (1280,),
          "out_proj": (1280, 2560), "A_log": (80,), "wq": (2560, 8, 80),
          "wk": (2560, 8, 80), "wg": (2560, 2560), "wd": (2560, 2560),
          "tok": (8192, 2560), "unembed": (2560, 8192)})])
def test_full_width_blocks(arch, blocks):
    """(f) a rank's blocks of the full-width model at (1, 4), drawn on the
    meta device: 2128 or 2612 ``in_proj`` columns, 1088 or 1312 conv
    channels, 16 or 20 SSM heads' rows of ``d_inner``, zamba2's shared
    block 8 of 32 heads and a quarter of ``d_ff``."""
    cfg = tconfig(arch)
    params = tbuild(cfg, "meta", _Ranked((1, 4), (0, 3))).init(None)
    got = {tree.path_str(p).split("/")[-1]: tuple(x.shape)
           for p, x in tree.leaves_with_paths(params)}
    for leaf, shape in blocks.items():
        assert got[leaf] == shape, (leaf, got[leaf], shape)


def test_state_shardings_refuse_a_ranks_blocks():
    """Under ``model > 1`` the rules need the whole shapes: a tree of a
    rank's blocks is refused; by default they read the config's."""
    cfg = tconfig(YI, smoke=True)
    mesh = MeshShape(("data", "model"), (1, 4))
    params = _one_process_params(YI)
    cut = dict(zip((tree.path_str(p) for p, _ in
                    tree.leaves_with_paths(params)),
                   _blocks(params, cfg, (1, 4), (0, 0))))
    blocks = tree.tree_map_with_path(lambda p, _: cut[tree.path_str(p)],
                                     params)
    with pytest.raises(ValueError, match="blocks"):
        tstep.state_shardings(cfg, mesh, {"params": blocks})
    assert [s.spec for s in tree.leaves(tstep.state_shardings(
        cfg, mesh)["params"])] == [s.spec for s in tree.leaves(
            tstep.state_shardings(cfg, mesh, {"params": params})["params"])]


# ---------------------------------------------------------------------------
# (j) FSDP over ``data``
# ---------------------------------------------------------------------------

def _fsdp_specs(name, shape=(2, 2)):
    cfg = _pcfg(name)
    return [s.spec for s in tree.leaves(tsh.params_shardings(
        _one_process_params(name), cfg,
        MeshShape(("data", "model"), shape), fsdp=True))]


@pytest.mark.parametrize("name", list(FSDP_VARIANTS))
def test_fsdp_variants_split_some_leaves_over_data(name):
    """Each widened variant has leaves split over ``data`` (the MLP or
    expert leaves, the embedding), leaves held whole over it (attention,
    norms), and leaves split over both ``data`` and ``model``."""
    axes = [{a for part in spec for a in tsh.spec_axes(part)}
            for spec in _fsdp_specs(name)]
    assert any("data" in a for a in axes)
    assert any("data" not in a for a in axes)
    assert any({"data", "model"} <= a for a in axes)


@pytest.mark.parametrize("name", list(FSDP_VARIANTS))
@pytest.mark.parametrize("shape", [(2, 2), (4, 1)])
def test_fsdp_init_keeps_the_rule_blocks(ranks, name, shape):
    """Each rank's FSDP ``init`` keeps exactly its block of the one-process
    ``init``'s leaves under ``params_shardings(..., fsdp=True)``, bitwise:
    no rank holds a data-split leaf whole."""
    cfg = _pcfg(name)
    whole = tbuild(cfg, "cpu").init(torch.Generator().manual_seed(7))
    for out in ranks[1]:
        coord = (out["coords"][(2, 2)] if shape == (2, 2)
                 else out["fsdp_coords_41"])
        got = tree.leaves(out[f"fsdp_init_{name}_{shape}"])
        want = _blocks(whole, cfg, shape, coord, fsdp=True)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert a.shape == b.shape and torch.equal(a, b)
    assert sum(a.numel() * shape[0] * shape[1] == b.numel()
               for a, b in zip(tree.leaves(
                   ranks[1][0][f"fsdp_init_{name}_{shape}"]),
                   tree.leaves(whole))) > 0


@pytest.mark.parametrize("name", list(FSDP_TRAIN))
def test_fsdp_train_step_matches_the_reference(ranks, name):
    """Two ZeRO-1 FSDP steps against the reference's one-device steps and
    the port's one process (losses, parameters, moments, grad norms),
    equal on every rank; each rank's first moments and parameters are its
    blocks under ``state_shardings(..., fsdp=True)``."""
    case = FSDP_TRAIN[name]
    _check_train(ranks[1], name, case["variant"])
    cfg = _pcfg(case["variant"])
    if case["mesh"] == "pod":
        mesh = MeshShape(("pod", "data", "model"), (2, 2, 1))
    else:
        mesh = MeshShape(("data", "model"), case["mesh"])
    shs = tstep.state_shardings(cfg, mesh, zero1=True, fsdp=True)
    whole = [tuple(p.shape) for p in tree.leaves(_one_process_params(
        case["variant"]))]
    want = [tsh.local_shape(w, s) for w, s in zip(
        whole, tree.leaves(shs["opt"]["mu"]))]
    want += [tsh.local_shape(w, s) for w, s in zip(
        whole, tree.leaves(shs["params"]))]
    for out in ranks[1]:
        assert out[f"{name}_shapes"] == want
    assert any(a != b for a, b in zip(want, whole))


def test_fsdp_forward_on_the_kernel_route(ranks):
    """The dense variant's FSDP forward on (2, 2) through the kernel
    route's wrappers (flash and the fused norm; their plain versions on
    the CPU), each rank its ``data`` rows, against the JAX one-device
    forward and the port's one process."""
    _check_logits(ranks[1], "fsdp_kernel_route", (2, 2), YI_W, "fsdp_toks",
                  kernel="pallas_paged")


def test_fsdp_global_norm(ranks):
    """The FSDP norm of this rank's blocks (squares summed over ``data``,
    ``model`` or both, as each leaf's spec names them) is the whole
    tree's on every rank."""
    leaves = _fsdp_inputs()["fsdp"]["norm_leaves"]
    want = float(topt.global_norm([torch.from_numpy(g) for g in leaves]))
    for out in ranks[1]:
        assert abs(out["fsdp_norm"] - want) <= 1e-6 * want, (
            out["fsdp_norm"], want)


def test_fsdp_checkpoint_restores_at_one_process(ranks):
    """The (2, 2) FSDP checkpoint (gathered over ``data`` and ``model``,
    written by rank 0) restores at one process, bitwise the gathered
    state."""
    outs = ranks[1]
    restored, step = ckpt.restore(outs[0]["fsdp_yi_22_ckpt"],
                                  template=_port_state(YI_W))
    assert step == STEPS
    for (p, a), b in zip(tree.leaves_with_paths(restored),
                         tree.leaves(outs[0]["fsdp_yi_22_full"])):
        assert torch.equal(a.detach(), b), tree.path_str(p)


def test_fsdp_checkpoint_reshards_onto_another_mesh(ranks):
    """The (2, 2) FSDP checkpoint restored onto (1, 4) without FSDP: each
    rank holds its blocks of the gathered state, bitwise."""
    outs = ranks[1]
    full = outs[0]["fsdp_yi_22_full"]
    shs = tstep.state_shardings(_pcfg(YI_W),
                                MeshShape(("data", "model"), (1, 4)),
                                zero1=True)
    for out in outs:
        step, restored = out["fsdp_restored_14"]
        assert step == STEPS
        at = _At((1, 4), out["coords"][(1, 4)])
        for (p, got), want, s in zip(tree.leaves_with_paths(restored),
                                     tree.leaves(full), tree.leaves(shs)):
            want = tsh.shard(want, tsh.Sharding(at, s.spec))
            assert torch.equal(got.detach(), want), tree.path_str(p)


@pytest.mark.parametrize("name", list(FSDP_VARIANTS))
def test_fsdp_model_refuses_serving(ranks, name):
    """A model built with FSDP refuses its cache entry points."""
    for out in ranks[1]:
        for shape in ((2, 2), (4, 1)):
            assert out[f"fsdp_serve_refused_{name}_{shape}"] == [
                "init_cache", "prefill", "decode_step"]


@pytest.mark.parametrize("arch", [MB, ZB, WH])
def test_fsdp_refused_by_name_for_the_other_families(arch):
    """mamba2, zamba2 and whisper have no FSDP execution: asked for it,
    ``build_model`` raises naming the ROADMAP item, never building an
    unsplit model."""
    mesh = MeshShape(("data", "model"), (2, 2))
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 3"):
        tbuild(tconfig(arch, smoke=True), "cpu", mesh, fsdp=True)
