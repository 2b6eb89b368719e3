"""The port's MoE family held against the JAX package on numpy inputs with
weights bridged by ``convert.from_jax``: routing (gates and experts),
``apply_moe`` under dense and sorted dispatch (with capacity drops, the
same pairs dropped), the prefill and decode logits of olmoe-1b-7b and
phi3.5-moe at their SMOKE sizes (paged and contiguous, ``"xla"`` and
``pallas_paged`` routes, fp32), greedy engine streams equal to the JAX
engine's with prefix sharing and preemption on, and the engine's refusal
of sorted dispatch."""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import build_model as jax_build  # noqa: E402
from repro.models import common as jcm  # noqa: E402
from repro.models import get_config as jax_config  # noqa: E402
from repro.serve.engine import Request as JaxRequest  # noqa: E402
from repro.serve.engine import ServeEngine as JaxEngine  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.kernels.moe_gmm import moe_gmm as gk  # noqa: E402
from repro_torch.models import build_model, get_config  # noqa: E402
from repro_torch.models import common as cm  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402

torch.set_num_threads(1)
F32 = dict(rtol=2e-3, atol=2e-3)
ARCHS = ["olmoe-1b-7b", "phi3.5-moe-42b-a6.6b"]


def _perturbed(params, seed=0):
    """Every leaf moved by seeded noise: norm weights start at one, so an
    unperturbed bridge would not test them."""
    leaves, tree = jax.tree_util.tree_flatten(params)
    rng = np.random.default_rng(seed)
    moved = [np.asarray(x, np.float32)
             + 0.1 * rng.standard_normal(np.shape(x)).astype(np.float32)
             for x in leaves]
    return jax.tree_util.tree_unflatten(tree, moved)


@functools.lru_cache(maxsize=None)
def _params(arch):
    """(JAX params, the port's bridged params) of ``arch``'s SMOKE config."""
    jcfg = jax_config(arch, smoke=True)
    jp = _perturbed(jax_build(jcfg).init(jax.random.PRNGKey(0)))
    return jp, convert.from_jax(jp, get_config(arch, smoke=True), "cpu")


def _layer0_moe(arch):
    jp, tp = _params(arch)
    return (jax.tree_util.tree_map(lambda a: a[0], jp["layers"])["moe"],
            tp["layers"][0]["moe"])


def _tokens(t, d, seed=1):
    return np.random.default_rng(seed).standard_normal((t, d)).astype(
        np.float32)


@pytest.mark.parametrize("arch", ARCHS)
def test_route_matches_jax(arch):
    cfg = get_config(arch, smoke=True)
    jp, tp = _layer0_moe(arch)
    xf = _tokens(96, cfg.d_model)
    jg, ji, joh, jaux = jcm._route(jp, jnp.asarray(xf),
                                   jax_config(arch, smoke=True))
    g, i, oh, aux = cm._route(tp, torch.from_numpy(xf), cfg)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(oh.numpy(), np.asarray(joh))
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), **F32)
    np.testing.assert_allclose(float(aux), float(jaux), **F32)


def _reference_keep(idx, n_experts, cap):
    """The reference's capacity rule in numpy: pairs in a stable sort by
    expert, kept while their rank in the expert is below ``cap``."""
    eidx = idx.reshape(-1)
    order = np.argsort(eidx, kind="stable")
    counts = np.bincount(eidx, minlength=n_experts)
    starts = np.cumsum(counts) - counts
    pos = np.arange(eidx.size) - starts[eidx[order]]
    return order, pos < cap


# (dispatch, capacity_factor): sorted at 0.5 drops pairs (512 tokens, the
# 128-slot capacity floor below the experts' mean load), at 1.25 drops none.
DISPATCH = {"dense": ("dense", 1.25), "sorted": ("sorted", 1.25),
            "sorted_drops": ("sorted", 0.5)}


@pytest.mark.parametrize("route", ["xla", "pallas_paged"])
@pytest.mark.parametrize("dispatch", list(DISPATCH))
@pytest.mark.parametrize("arch", ARCHS)
def test_apply_moe_matches_jax(arch, dispatch, route):
    """Both dispatches on both routes within fp32 2e-3 of the reference;
    under sorted dispatch the same (token, choice) pairs are dropped."""
    mode, cf = DISPATCH[dispatch]
    over = dict(moe_dispatch=mode, capacity_factor=cf)
    jcfg = dataclasses.replace(jax_config(arch, smoke=True), **over)
    tcfg = dataclasses.replace(get_config(arch, smoke=True),
                               decode_kernel=route, **over)
    jp, tp = _layer0_moe(arch)
    x = _tokens(4 * 128, tcfg.d_model, seed=2).reshape(4, 128, -1)
    jy, jaux = jcm.apply_moe(jp, jnp.asarray(x), jcfg)
    gk.reset_counters()
    y, aux = cm.apply_moe(tp, torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **F32)
    np.testing.assert_allclose(float(aux), float(jaux), **F32)
    assert gk.grouped_matmul_plain.calls == (3 if route != "xla" else 0)
    if mode == "sorted":
        t = x.shape[0] * x.shape[1]
        cap = cm.moe_capacity(t, tcfg)
        _, ji, _, _ = jcm._route(jp, jnp.asarray(x.reshape(t, -1)), jcfg)
        want_order, want_keep = _reference_keep(np.asarray(ji),
                                                tcfg.n_experts, cap)
        order, _, keep, _ = cm.sorted_slots(torch.from_numpy(
            np.array(ji)).long(), tcfg.n_experts, cap)
        np.testing.assert_array_equal(order.numpy(), want_order)
        np.testing.assert_array_equal(keep.numpy(), want_keep)
        assert bool(want_keep.all()) == (dispatch == "sorted")


@functools.lru_cache(maxsize=None)
def _jax_logits(arch, layout):
    """The reference's logits (its XLA path) for a ragged prefill and three
    decode steps, one slot parked midway: (prefill, steps, lengths)."""
    jcfg = dataclasses.replace(jax_config(arch, smoke=True),
                               cache_layout=layout, kv_page_size=8)
    jp, _ = _params(arch)
    jm = jax_build(jcfg)
    cache = jm.init_cache(jp, batch=3, max_len=32)
    if layout == "paged":
        cache["pages"] = jnp.asarray(TABLE)
    toks, seg = _prompt(jcfg.vocab)
    logits, cache = jax.jit(jm.prefill)(jp, cache, jnp.asarray(toks),
                                        seg_lens=jnp.asarray(seg))
    out = [np.asarray(logits)]
    dec = jax.jit(jm.decode_step)
    for step in range(3):
        nxt = out[-1][:, -1].argmax(-1).astype(np.int32)[:, None]
        logits, cache = dec(jp, cache, jnp.asarray(nxt),
                            seg_lens=jnp.asarray(_active(step)))
        out.append(np.asarray(logits))
    return out, np.asarray(cache["lengths"])


TABLE = np.array([[5, 0, 9, 2], [1, 3, -1, -1], [11, 7, 4, -1]], np.int32)


def _prompt(vocab):
    rng = np.random.default_rng(1)
    return (rng.integers(0, vocab, (3, 16)).astype(np.int32),
            np.array([16, 9, 3], np.int32))


def _active(step):
    return np.array([1, 1, 0 if step == 1 else 1], np.int32)


@pytest.mark.parametrize("route", ["xla", "pallas_paged"])
@pytest.mark.parametrize("layout", ["contiguous", "paged"])
@pytest.mark.parametrize("arch", ARCHS)
def test_logits_match_jax(arch, layout, route):
    """Ragged prefill then decode steps: the port's logits within fp32 2e-3
    of repro.models.transformer's on the same weights."""
    want, want_len = _jax_logits(arch, layout)
    tcfg = dataclasses.replace(get_config(arch, smoke=True),
                               cache_layout=layout, kv_page_size=8,
                               decode_kernel=route, decode_splits=2)
    _, tp = _params(arch)
    tm = build_model(tcfg, "cpu")
    cache = tm.init_cache(tp, batch=3, max_len=32)
    if layout == "paged":
        cache["pages"] = torch.from_numpy(TABLE)
    toks, seg = _prompt(tcfg.vocab)
    logits, cache = tm.prefill(tp, cache, torch.from_numpy(toks),
                               seg_lens=torch.from_numpy(seg))
    np.testing.assert_allclose(logits.numpy(), want[0], **F32)
    for step in range(3):
        nxt = want[step][:, -1].argmax(-1).astype(np.int32)[:, None]
        logits, cache = tm.decode_step(
            tp, cache, torch.from_numpy(nxt),
            seg_lens=torch.from_numpy(_active(step)))
        np.testing.assert_allclose(logits.numpy(), want[step + 1], **F32)
    np.testing.assert_array_equal(cache["lengths"].numpy(), want_len)


def _workload(cls):
    """Five requests, three on one 17-token prefix (two full pages of 8)."""
    rng = np.random.default_rng(9)
    common = rng.integers(0, 256, 17).astype(np.int32)

    def tail(n):
        return rng.integers(0, 256, n).astype(np.int32)

    spec = [(common, 6), (np.concatenate([common, tail(3)]), 6),
            (tail(10), 8), (np.concatenate([common, tail(5)]), 5),
            (tail(6), 6)]
    return [cls(prompt=p, max_new_tokens=m, id=f"r{i}")
            for i, (p, m) in enumerate(spec)]


PAGED = dict(cache_layout="paged", kv_page_size=8, decode_splits=2,
             prefix_sharing=True, preemption=True)


@pytest.mark.parametrize("n_pages", [6, None])
def test_engine_streams_equal_jax_engine(n_pages):
    """olmoe SMOKE through both engines with prefix sharing and preemption
    on (6 pages force preemption; None is the full pool): greedy streams,
    hits and preemptions equal, every page back on the free list."""
    arch = "olmoe-1b-7b"
    jp, tp = _params(arch)
    kw = dict(batch_slots=3, max_len=48, chunk_size=2, n_pages=n_pages)
    jeng = JaxEngine(dataclasses.replace(jax_config(arch, smoke=True),
                                         **PAGED), jp, **kw)
    want = jeng.run(_workload(JaxRequest))
    eng = ServeEngine(dataclasses.replace(get_config(arch, smoke=True),
                                          decode_kernel="pallas_paged",
                                          **PAGED), tp, device="cpu", **kw)
    got = eng.run(_workload(Request))
    assert [r.generated for r in got] == [r.generated for r in want]
    keys = ("preempted", "prefix_hits_fresh", "admission_waves", "chunks")
    stats, jstats = eng.serve_stats(), jeng.serve_stats()
    assert {k: stats[k] for k in keys} == {k: jstats[k] for k in keys}
    assert stats["prefix_hits_fresh"] > 0
    assert (stats["preempted"] > 0) == (n_pages is not None)
    assert sorted(eng.free_pages) == list(range(eng.n_pages))


def test_engine_refuses_sorted_dispatch():
    """Both engines refuse sorted dispatch: padding would contend for
    expert capacity."""
    arch = "olmoe-1b-7b"
    jp, tp = _params(arch)
    kw = dict(batch_slots=2, max_len=16)
    with pytest.raises(AssertionError, match="moe_dispatch='dense'"):
        JaxEngine(dataclasses.replace(jax_config(arch, smoke=True),
                                      moe_dispatch="sorted"), jp, **kw)
    with pytest.raises(ValueError, match="moe_dispatch='dense'"):
        ServeEngine(dataclasses.replace(get_config(arch, smoke=True),
                                        moe_dispatch="sorted"), tp,
                    device="cpu", **kw)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_and_bridge_keep_the_router_fp32(arch):
    """A bf16 model keeps its router in fp32, drawn anew or bridged; the
    expert weights take the model's dtype and the reference's shapes."""
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="bfloat16")
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    drawn = convert.init(cfg, torch.Generator().manual_seed(0), "cpu")
    jparams = jax_build(dataclasses.replace(
        jax_config(arch, smoke=True), dtype="bfloat16")).init(
        jax.random.PRNGKey(0))
    bridged = convert.from_jax(jparams, cfg, "cpu")
    for p in (drawn, bridged):
        moe = p["layers"][0]["moe"]
        assert "mlp" not in p["layers"][0] and len(p["layers"]) == 2
        assert moe["router"].dtype == torch.float32
        assert tuple(moe["router"].shape) == (d, e)
        assert {k: (tuple(moe[k].shape), moe[k].dtype)
                for k in ("wg", "wu", "wd")} == {
            "wg": ((e, d, f), torch.bfloat16),
            "wu": ((e, d, f), torch.bfloat16),
            "wd": ((e, f, d), torch.bfloat16)}
    np.testing.assert_array_equal(
        bridged["layers"][1]["moe"]["wd"].float().numpy(),
        np.asarray(jparams["layers"]["moe"]["wd"][1], np.float32))
    assert abs(drawn["layers"][0]["moe"]["wg"].float().std().item()
               - d ** -0.5) < 0.02
