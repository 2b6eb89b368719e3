"""The port's trainer held against ``repro.train`` and the reference's
``loss`` on the same weights and batches: loss and per-leaf gradients for
every family, the cross-entropy (padded vocab, the chunked logsumexp and
its backward), AdamW steps (params, moments, count, lr, grad norm), the
weight-decay mask leaf by leaf, microbatching, the schedules, the three
remat policies and the kernel-route forward.  SMOKE configs, fp32, numpy
inputs from a seed.

Tolerances: losses to 1e-5 relative, gradients to 2e-3 (the reference's
fp32 kernel tolerance, ``tests/test_kernels.py``), and the AdamW moments,
which are linear and quadratic in them, likewise; parameters after AdamW
steps to 5e-5, a twentieth of one step's lr (an element whose gradient is
near zero takes a step of lr g / (|g| + eps), which the two frameworks'
summation orders move); schedules to 1e-6 relative.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.remat import RematPolicy as JaxRemat  # noqa: E402
from repro.data.pipeline import SyntheticLM as JaxSyntheticLM  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.models import common as jcm  # noqa: E402
from repro.models import get_config as jax_config  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train import step as jstep  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import remat  # noqa: E402
from repro_torch.core.remat import RematPolicy  # noqa: E402
from repro_torch.data.pipeline import SyntheticLM  # noqa: E402
from repro_torch.models import build_model, get_config  # noqa: E402
from repro_torch.models import common as cm  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402
from repro_torch.utils import tree  # noqa: E402

torch.set_num_threads(1)
GRAD = dict(rtol=2e-3, atol=2e-3)
STATE = dict(rtol=1e-5, atol=5e-5)
FAMILIES = ("yi-9b", "olmoe-1b-7b", "mamba2-1.3b", "zamba2-2.7b",
            "whisper-small", "llama-3.2-vision-90b")


@functools.lru_cache(maxsize=None)
def _jax_params(arch):
    """The reference's init with every leaf moved by seeded noise (norm
    weights start at 1, biases at 0), as numpy."""
    params = jax.jit(jax_build(jax_config(arch, smoke=True)).init)(
        jax.random.PRNGKey(0))
    leaves, treedef = jax.tree_util.tree_flatten(params)
    rng = np.random.default_rng(1)
    moved = [np.asarray(x, np.float32)
             + 0.05 * rng.standard_normal(np.shape(x)).astype(np.float32)
             for x in leaves]
    return jax.tree_util.tree_unflatten(treedef, moved)


def _port_params(arch):
    params = convert.from_jax(_jax_params(arch), get_config(arch, smoke=True),
                              "cpu")
    for p in tree.leaves(params):
        p.requires_grad_(True)
    return params


def _batch(arch, step=0, b=2, s=16):
    return SyntheticLM(get_config(arch, smoke=True), b, s, seed=3)(step)


def _torch_batch(batch):
    return tstep.batch_to_device(batch, "cpu")


def _grad_tree(params, grads):
    by_id = {id(p): g for p, g in zip(tree.leaves(params), grads)}
    return tree.tree_map(lambda p: by_id[id(p)], params)


def _assert_trees(got, want, **tol):
    gl, gdef = jax.tree_util.tree_flatten(got)
    wl, wdef = jax.tree_util.tree_flatten(want)
    assert gdef == wdef
    for g, w in zip(gl, wl):
        np.testing.assert_allclose(np.asarray(g, np.float32),
                                   np.asarray(w, np.float32), **tol)


@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_and_grads_match_jax(arch):
    jcfg, cfg = jax_config(arch, smoke=True), get_config(arch, smoke=True)
    batch = _batch(arch)
    jmodel = jax_build(jcfg)
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jmodel.loss(p, {k: jnp.asarray(v) for k, v in
                                  batch.items()}), has_aux=True))(
        _jax_params(arch))
    model = build_model(cfg, "cpu")
    params = _port_params(arch)
    loss, met = model.loss(params, _torch_batch(batch))
    grads = torch.autograd.grad(loss, tree.leaves(params))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(met["aux"].item(), float(jmet["aux"]),
                               rtol=1e-5, atol=1e-7)
    _assert_trees(convert.to_jax_layout(_grad_tree(params, grads), cfg),
                  jgrads, **GRAD)


def test_cross_entropy_padded_vocab():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((2, 5, 96)).astype(np.float32) * 3
    labels = rng.integers(0, 80, (2, 5)).astype(np.int32)
    want = jcm.cross_entropy(jnp.asarray(logits), jnp.asarray(labels), 80)
    got = cm.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                           80)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    # The padded columns carry no probability: moving them moves nothing.
    logits[..., 80:] = 50.0
    assert float(cm.cross_entropy(torch.from_numpy(logits),
                                  torch.from_numpy(labels), 80)) == float(got)


def test_chunked_logsumexp_and_its_backward():
    """The chunked path at 2.5 chunks of vocab, padded columns past 40000:
    its value against the reference's and the plain masked logsumexp, its
    hand-written backward against autograd through the plain one."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 3, 40960)).astype(np.float32) * 4
    want = jcm._chunked_logsumexp(jnp.asarray(x), 40000)
    t = torch.from_numpy(x).requires_grad_(True)
    got = cm._chunked_logsumexp(t, 40000)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-6)
    w = torch.from_numpy(rng.standard_normal((2, 3)).astype(np.float32))
    (gx,) = torch.autograd.grad((got * w).sum(), t)
    t2 = torch.from_numpy(x).requires_grad_(True)
    plain = torch.logsumexp(t2[..., :40000], dim=-1)
    (px,) = torch.autograd.grad((plain * w).sum(), t2)
    np.testing.assert_allclose(gx.numpy(), px.numpy(), rtol=1e-5, atol=1e-7)
    assert bool((gx[..., 40000:] == 0).all())


def test_cross_entropy_chunked_branch(monkeypatch):
    """Above the element threshold the loss takes the chunked branch (the
    threshold lowered here to reach it at a small size): equal to the
    reference's plain branch, gradients included."""
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((2, 4, 20000)).astype(np.float32)
    labels = rng.integers(0, 19000, (2, 4)).astype(np.int32)

    def jce(lg):
        return jcm.cross_entropy(lg, jnp.asarray(labels), 19000)

    want, jg = jax.value_and_grad(jce)(jnp.asarray(logits))
    monkeypatch.setattr(cm, "_CE_CHUNK_MIN_ELEMENTS", 1000)
    t = torch.from_numpy(logits).requires_grad_(True)
    got = cm.cross_entropy(t, torch.from_numpy(labels), 19000)
    (g,) = torch.autograd.grad(got, t)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-4,
                               atol=1e-8)


def _jax_state(arch):
    params = jax.tree_util.tree_map(jnp.asarray, _jax_params(arch))
    return {"params": params, "opt": jopt.init_state(params)}


def _port_state(arch):
    params = _port_params(arch)
    return {"params": params, "opt": opt.init_state(params)}


def _assert_states(state, jstate, cfg):
    _assert_trees(convert.to_jax_layout(state["params"], cfg),
                  jstate["params"], **STATE)
    for m in ("mu", "nu"):
        _assert_trees(convert.to_jax_layout(state["opt"][m], cfg),
                      jstate["opt"][m], rtol=2e-3, atol=1e-8)
    assert int(state["opt"]["count"]) == int(jstate["opt"]["count"])


@pytest.mark.parametrize("arch, steps", [("yi-9b", 1), ("yi-9b", 3),
                                         ("olmoe-1b-7b", 2)])
def test_train_steps_match_jax(arch, steps):
    jcfg, cfg = jax_config(arch, smoke=True), get_config(arch, smoke=True)
    adamw = dict(lr=1e-3, warmup_steps=2, total_steps=20, schedule="wsd")
    jts, _ = jstep.make_train_step(jcfg, jstep.TrainConfig(
        adamw=jopt.AdamWConfig(**adamw), batch_axes=()))
    jts = jax.jit(jts)
    ts, _ = tstep.make_train_step(cfg, tstep.TrainConfig(
        adamw=opt.AdamWConfig(**adamw)), "cpu")
    jstate, state = _jax_state(arch), _port_state(arch)
    for i in range(steps):
        batch = _batch(arch, i % 2)
        jstate, jm = jts(jstate, {k: jnp.asarray(v) for k, v in
                                  batch.items()})
        state, m = ts(state, batch)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-4)
        assert float(m["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)
    _assert_states(state, jstate, cfg)


@pytest.mark.parametrize("arch", ("yi-9b", "zamba2-2.7b", "whisper-small",
                                  "llama-3.2-vision-90b"))
def test_weight_decay_mask_matches_jax(arch):
    """A step with zero gradients: only decoupled weight decay moves a
    leaf.  The leaves that move, and by how much, equal the reference's,
    whose layers are stacked (a layer's norm weight decays there)."""
    cfg = get_config(arch, smoke=True)
    adamw = dict(lr=0.5, warmup_steps=0, schedule="const", weight_decay=0.1)
    jparams = jax.tree_util.tree_map(jnp.asarray, _jax_params(arch))
    jnew, _, _ = jax.jit(lambda p: jopt.apply_updates(
        p, jax.tree_util.tree_map(jnp.zeros_like, p), jopt.init_state(p),
        jopt.AdamWConfig(**adamw)))(jparams)
    params = _port_params(arch)
    before = convert.to_jax_layout(params, cfg)
    opt.apply_updates(params, [torch.zeros_like(p) for p in
                               tree.leaves(params)],
                      opt.init_state(params), opt.AdamWConfig(**adamw))
    after = convert.to_jax_layout(params, cfg)
    moved = jax.tree_util.tree_map(lambda a, b: bool((a != b).any()),
                                   before, after)
    jmoved = jax.tree_util.tree_map(
        lambda a, b: bool((np.asarray(a) != np.asarray(b)).any()),
        jparams, jnew)
    assert moved == jmoved
    assert not all(jax.tree_util.tree_leaves(moved))      # ln_f stays
    assert any(jax.tree_util.tree_leaves(moved))
    _assert_trees(after, jnew, rtol=1e-6, atol=1e-7)


def test_decay_mask_counts_stacked_axes():
    params = _port_params("llama-3.2-vision-90b")
    mask = dict(zip((tree.path_str(p) for p, _ in
                     tree.leaves_with_paths(params)),
                    opt.decay_mask(params)))
    assert mask["self_layers/0/0/ln1/w"] and mask["cross_layers/0/ln1/w"]
    assert not mask["ln_f/w"] and mask["vis_proj"]


def test_microbatch_equivalence():
    """mb=4 gradient accumulation == mb=1 on the same batch, and equal to
    the reference's mb=4 step."""
    cfg = get_config("yi-9b", smoke=True)
    batch = SyntheticLM(cfg, 4, 16, seed=3)(0)
    adamw = dict(lr=1e-3, warmup_steps=0, total_steps=10)
    outs = []
    for mb in (1, 4):
        ts, _ = tstep.make_train_step(cfg, tstep.TrainConfig(
            adamw=opt.AdamWConfig(**adamw), microbatch=mb), "cpu")
        state, m = ts(_port_state("yi-9b"), batch)
        outs.append((state, m))
    _assert_trees(convert.to_jax_layout(outs[0][0]["params"], cfg),
                  convert.to_jax_layout(outs[1][0]["params"], cfg),
                  rtol=2e-3, atol=2e-3)
    assert float(outs[1][1]["aux"]) == 0.0
    jts, _ = jstep.make_train_step(jax_config("yi-9b", smoke=True),
                                   jstep.TrainConfig(
                                       adamw=jopt.AdamWConfig(**adamw),
                                       microbatch=4, batch_axes=()))
    jstate, jm = jax.jit(jts)(_jax_state("yi-9b"),
                              {k: jnp.asarray(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(outs[1][1]["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    _assert_states(outs[1][0], jstate, cfg)


@pytest.mark.parametrize("schedule", ["cosine", "wsd", "const"])
def test_schedules_match_jax(schedule):
    kw = dict(lr=2e-3, warmup_steps=10, total_steps=100, schedule=schedule,
              decay_frac=0.2, min_lr_frac=0.1)
    for step in (0, 1, 5, 10, 11, 50, 79, 80, 81, 99, 100, 150):
        got = float(opt.schedule_lr(opt.AdamWConfig(**kw),
                                    torch.tensor(step, dtype=torch.int32)))
        want = float(jopt.schedule_lr(jopt.AdamWConfig(**kw),
                                      jnp.asarray(step)))
        assert got == pytest.approx(want, rel=1e-6, abs=1e-12), step


def test_reference_schedule_points():
    c = opt.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100,
                        schedule="wsd", decay_frac=0.2, min_lr_frac=0.1)
    lr = lambda s: float(opt.schedule_lr(c, torch.tensor(s)))  # noqa: E731
    assert lr(5) == pytest.approx(0.5, rel=1e-3)
    assert lr(50) == pytest.approx(1.0, rel=1e-3)
    assert 0.09 < lr(99) < 0.25


@pytest.mark.parametrize("arch", ("yi-9b", "zamba2-2.7b"))
def test_remat_policies_bitwise_equal(arch):
    cfg = get_config(arch, smoke=True)
    model = build_model(cfg, "cpu")
    batch = _torch_batch(_batch(arch))
    params = _port_params(arch)
    outs = {}
    for pol in RematPolicy:
        loss, _ = model.loss(params, batch, remat=pol)
        outs[pol] = (loss, torch.autograd.grad(loss, tree.leaves(params)))
    base_loss, base_grads = outs[RematPolicy.SAVE_ALL]
    for pol, (loss, grads) in outs.items():
        assert torch.equal(loss, base_loss), pol
        assert all(torch.equal(a, b) for a, b in zip(grads, base_grads)), pol


def test_save_dots_saves_only_matmul_outputs(monkeypatch):
    """What each policy keeps for the backward of yi-9b SMOKE's layers.
    Inside a checkpointed body the policy decides: under SAVE_DOTS it
    keeps exactly the 2-D ``mm`` outputs, 7 a layer (q, k, v, o, gate,
    up, down), and recomputes the rest (the attention's ``bmm`` too).
    Outside the bodies ``saved_tensors_hooks`` count what autograd packs:
    SAVE_DOTS and RECOMPUTE leave the same tensors there (the embedding,
    head and loss), SAVE_ALL every layer's as well."""
    cfg = get_config("yi-9b", smoke=True)
    model = build_model(cfg, "cpu")
    batch = _torch_batch(_batch("yi-9b"))
    params = _port_params("yi-9b")
    decided = []
    policy_fn = remat._dots_saveable

    def spy(ctx, op, *args, **kwargs):
        policy = policy_fn(ctx, op, *args, **kwargs)
        if not ctx.is_recompute:
            decided.append((op, policy))
        return policy

    monkeypatch.setattr(remat, "_dots_saveable", spy)
    packed = {}
    for pol in RematPolicy:
        n = []
        with torch.autograd.graph.saved_tensors_hooks(
                lambda t: n.append(t.numel() * t.element_size()) or t,
                lambda t: t):
            loss, _ = model.loss(params, batch, remat=pol)
        torch.autograd.grad(loss, tree.leaves(params))
        packed[pol] = n
    saved = [op for op, policy in decided
             if policy == torch.utils.checkpoint.CheckpointPolicy.MUST_SAVE]
    assert saved == [torch.ops.aten.mm.default] * (7 * cfg.n_layers)
    assert torch.ops.aten.bmm.default in {op for op, _ in decided}
    assert packed[RematPolicy.SAVE_DOTS] == packed[RematPolicy.RECOMPUTE]
    assert sum(packed[RematPolicy.SAVE_ALL]) > 2 * sum(
        packed[RematPolicy.RECOMPUTE])


def test_save_dots_refuses_without_the_selective_api(monkeypatch):
    monkeypatch.delattr(torch.utils.checkpoint,
                        "create_selective_checkpoint_contexts")
    with pytest.raises(NotImplementedError, match="SAVE_DOTS"):
        remat.apply_remat(lambda x: x, RematPolicy.SAVE_DOTS)
    assert remat.apply_remat(abs, RematPolicy.SAVE_ALL) is abs


@pytest.mark.parametrize("arch", FAMILIES)
def test_forward_kernel_route_equals_xla(arch):
    """``forward`` honours ``decode_kernel``: the kernel route (each
    kernel's plain version on CPU tensors) against ``"xla"``, no grad."""
    cfg = get_config(arch, smoke=True)
    batch = _torch_batch(_batch(arch))
    params = _port_params(arch)
    extras = {k: batch[k] for k in ("vis", "frames") if k in batch}
    out = {}
    with torch.no_grad():
        for kernel in ("xla", "pallas_paged"):
            model = build_model(dataclasses.replace(cfg, decode_kernel=kernel),
                                "cpu")
            out[kernel] = model.forward(params, batch["tokens"], **extras)
    np.testing.assert_allclose(out["pallas_paged"][0].numpy(),
                               out["xla"][0].numpy(), rtol=1e-4, atol=1e-5)
    assert float(out["pallas_paged"][1]) == pytest.approx(
        float(out["xla"][1]), rel=1e-5)


def test_train_step_differentiates_the_plain_route():
    cfg = dataclasses.replace(get_config("yi-9b", smoke=True),
                              decode_kernel="pallas_paged")
    _, model = tstep.make_train_step(cfg, tstep.TrainConfig(), "cpu")
    assert model.config.decode_kernel == "xla"


def test_jax_remat_enum_values_match():
    assert [p.value for p in RematPolicy] == [p.value for p in JaxRemat]


def test_batches_bitwise_equal_to_reference():
    for arch in ("yi-9b", "whisper-small", "llama-3.2-vision-90b"):
        a = SyntheticLM(get_config(arch, smoke=True), 3, 16, seed=9)(4)
        b = JaxSyntheticLM(jax_config(arch, smoke=True), 3, 16, seed=9)(4)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


def test_train_state_from_jax_round_trips():
    jstate = _jax_state("whisper-small")
    cfg = get_config("whisper-small", smoke=True)
    state = convert.train_state_from_jax(jstate, cfg, "cpu")
    assert all(p.requires_grad for p in tree.leaves(state["params"]))
    for key in ("params",):
        _assert_trees(convert.to_jax_layout(state[key], cfg), jstate[key],
                      rtol=0, atol=0)
    _assert_trees(convert.to_jax_layout(state["opt"]["mu"], cfg),
                  jstate["opt"]["mu"], rtol=0, atol=0)
    assert state["opt"]["count"].dtype == torch.int32
    assert tree.tree_param_count(state["params"]) == sum(
        x.size for x in jax.tree_util.tree_leaves(jstate["params"]))

