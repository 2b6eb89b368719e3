"""The port's recurrent families (mamba2, zamba2) held against the JAX
package on the SMOKE configs in fp32 with weights bridged by
``convert.from_jax``: logits within 2e-3 on every cache layout and kernel
route, the ragged and parked-slot contracts of the cache (state bitwise),
and the ServeEngine's greedy streams and lifecycle counters equal to the
JAX engine's, through slot reuse, the mamba2 paged fallback, chaos-forced
preemption and a short zamba2 page pool."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import build_model as jax_build  # noqa: E402
from repro.models import get_config as jax_config  # noqa: E402
from repro.serve.engine import Request as JaxRequest  # noqa: E402
from repro.serve.engine import ServeEngine as JaxEngine  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.kernels.fused_norm import fused_norm as nk  # noqa: E402
from repro_torch.kernels.ssd import ssd as sk  # noqa: E402
from repro_torch.models import build_model, get_config  # noqa: E402
from repro_torch.models.common import reset_recurrent  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402

torch.set_num_threads(1)
F32 = dict(rtol=2e-3, atol=2e-3)
ARCHS = ("mamba2-1.3b", "zamba2-2.7b")
PAGED = dict(cache_layout="paged", kv_page_size=8, decode_splits=2)
COUNTERS = ("preempted", "preempted_forced", "admitted_fresh", "readmitted",
            "recompute_tokens", "admission_waves", "chunks",
            "decode_tokens", "prefill_tokens")


def _perturbed(params, seed):
    """Every leaf moved by seeded noise: the init sets norm weights, D and
    biases to constants, so an unperturbed bridge would not test them."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32)
        + 0.1 * rng.standard_normal(np.shape(a)).astype(np.float32), params)


@pytest.fixture(scope="module")
def params():
    """arch -> (JAX params, the port's bridged copy), made once a module."""
    made = {}

    def get(arch):
        if arch not in made:
            jp = _perturbed(jax_build(jax_config(arch, smoke=True)).init(
                jax.random.PRNGKey(0)), 1)
            made[arch] = jp, convert.from_jax(
                jp, get_config(arch, smoke=True), "cpu")
        return made[arch]

    return get


def _cfgs(arch, **over):
    return (dataclasses.replace(jax_config(arch, smoke=True), **over),
            dataclasses.replace(get_config(arch, smoke=True), **over))


ROUTES = [("mamba2-1.3b", "contiguous", "xla"),
          ("mamba2-1.3b", "contiguous", "pallas_paged"),
          ("zamba2-2.7b", "contiguous", "xla"),
          ("zamba2-2.7b", "contiguous", "pallas_paged"),
          ("zamba2-2.7b", "paged", "xla"),
          ("zamba2-2.7b", "paged", "pallas_gather"),
          ("zamba2-2.7b", "paged", "pallas_paged")]


@pytest.mark.parametrize("arch, layout, kernel", ROUTES)
def test_logits_match_jax(params, arch, layout, kernel):
    """Ragged prefill, decode steps with a slot parked midway, and a
    continuation prefill at nonzero cursors: logits within fp32 2e-3 of the
    reference's, SSM state too, cursors equal."""
    over = dict(PAGED, cache_layout=layout, decode_kernel=kernel)
    jcfg, tcfg = _cfgs(arch, **over)
    jp, tp = params(arch)
    b, max_len = 3, 32
    jm, tm = jax_build(jcfg), build_model(tcfg, "cpu")
    jc = jm.init_cache(jp, batch=b, max_len=max_len)
    tc = tm.init_cache(tp, batch=b, max_len=max_len)
    assert ("pages" in tc) == (arch == "zamba2-2.7b" and layout == "paged")
    if "pages" in tc:
        table = np.array([[5, 0, 9, 2], [1, 3, -1, -1], [11, 7, 4, -1]],
                         np.int32)
        jc["pages"] = jnp.asarray(table)
        tc["pages"] = torch.from_numpy(table)
    rng = np.random.default_rng(2)
    sk.reset_counters()
    nk.reset_counters()
    jpre, jdec = jax.jit(jm.prefill), jax.jit(jm.decode_step)

    def both(fn_j, fn_t, toks, seg):
        nonlocal jc, tc
        jl, jc = fn_j(jp, jc, jnp.asarray(toks), seg_lens=jnp.asarray(seg))
        tl, tc = fn_t(tp, tc, torch.from_numpy(toks),
                      seg_lens=torch.from_numpy(seg))
        return np.asarray(jl), tl.numpy()

    toks = rng.integers(0, jcfg.vocab, (b, 12)).astype(np.int32)
    jl, tl = both(jpre, tm.prefill, toks, np.array([12, 7, 3], np.int32))
    np.testing.assert_allclose(tl, jl, **F32)
    for step in range(3):
        nxt = jl[:, -1].argmax(-1).astype(np.int32)[:, None]
        act = np.array([1, 1, 0 if step == 1 else 1], np.int32)
        jl, tl = both(jdec, tm.decode_step, nxt, act)
        np.testing.assert_allclose(tl, jl, **F32)
    seg = np.array([9, 0, 5], np.int32)      # slot 1 parked
    jl, tl = both(jpre, tm.prefill,
                  rng.integers(0, jcfg.vocab, (b, 9)).astype(np.int32), seg)
    np.testing.assert_allclose(tl[seg > 0], jl[seg > 0], **F32)
    np.testing.assert_allclose(tc["ssm"].numpy(), np.asarray(jc["ssm"]),
                               **F32)
    np.testing.assert_array_equal(tc["lengths"].numpy(),
                                  np.asarray(jc["lengths"]))
    # Two prefills (s > 1) scan every Mamba-2 layer once each; the kernel
    # routes reach the scan through its dispatching wrapper (the plain
    # version on the CPU), as they reach the fused norm.
    L, k = tcfg.n_layers, tcfg.shared_attn_every
    assert sk.ssd_plain.calls == 2 * L and sk.ssd.launches == 0
    norms = L + 1 + (2 * (L // k) if k else 0)         # per call, 5 calls
    assert nk.fused_norm_plain.calls == (0 if kernel == "xla" else 5 * norms)


@pytest.mark.parametrize("arch", ARCHS)
def test_ragged_prefill_matches_per_row_uniform(params, arch):
    """The ragged contract (tests/test_serve.py): a right-padded ragged
    prefill and a decode step give each slot the logits of its own uniform
    run."""
    _, cfg = _cfgs(arch)
    _, tp = params(arch)
    model = build_model(cfg, "cpu")
    lens = [5, 8]
    toks = np.random.default_rng(3).integers(0, cfg.vocab, (2, 8)).astype(
        np.int32)
    for b, n in enumerate(lens):
        toks[b, n:] = 0                  # right-pad garbage must not leak in
    cache = model.init_cache(tp, batch=2, max_len=16)
    lg, cache = model.prefill(tp, cache, torch.from_numpy(toks),
                              seg_lens=torch.tensor(lens, dtype=torch.int32))
    nxt = lg[:, -1].argmax(-1).to(torch.int32)
    lg2, _ = model.decode_step(tp, cache, nxt[:, None],
                               seg_lens=torch.ones(2, dtype=torch.int32))
    for b, n in enumerate(lens):
        c1 = model.init_cache(tp, batch=1, max_len=16)
        l1, c1 = model.prefill(tp, c1, torch.from_numpy(toks[b:b + 1, :n]))
        torch.testing.assert_close(lg[b, -1], l1[0, -1], **F32)
        assert int(l1[0, -1].argmax()) == int(nxt[b])
        l2, _ = model.decode_step(tp, c1, nxt[b].reshape(1, 1))
        torch.testing.assert_close(lg2[b, -1], l2[0, -1], **F32)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("kernel", ["xla", "pallas_paged"])
def test_parked_slot_state_untouched(params, arch, kernel):
    """seg_lens == 0 leaves a slot's recurrent state, cursor and KV bit
    for bit, in a decode step and in a prefill (the SSD scan with dt = 0 on
    every row of the slot)."""
    _, cfg = _cfgs(arch, decode_kernel=kernel)
    _, tp = params(arch)
    model = build_model(cfg, "cpu")
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab, (2, 6)).astype(np.int32))
    cache = model.init_cache(tp, batch=2, max_len=16)
    _, cache = model.prefill(tp, cache, toks)

    def snapshot(c):
        leaves = [c["ssm"][:, 0], c["conv"][:, 0]]
        if "kv" in c:
            # The ring's public view: position max_len is the sink.
            leaves += [c["kv"]["k"][:, 0, :-1], c["kv"]["v"][:, 0, :-1]]
        return [t.clone() for t in leaves] + [int(c["lengths"][0])]

    before = snapshot(cache)
    _, cache = model.decode_step(tp, cache, torch.zeros(2, 1,
                                                            dtype=torch.int32),
                                 seg_lens=torch.tensor([0, 1],
                                                       dtype=torch.int32))
    _, cache = model.prefill(tp, cache, toks,
                             seg_lens=torch.tensor([0, 6], dtype=torch.int32))
    after = snapshot(cache)
    assert after[-1] == before[-1]
    assert int(cache["lengths"][1]) == 6 + 1 + 6
    for a, b in zip(after[:-1], before[:-1]):
        assert torch.equal(a, b)


def test_reset_recurrent_batch_axis_guard():
    """A layout with its batch elsewhere than axis 1 raises, and works
    when the axis is passed (tests/test_serve.py)."""
    mask = torch.tensor([True, False])
    cache = {"lengths": torch.tensor([3, 4], dtype=torch.int32),
             "ssm": torch.ones(3, 2, 4), "conv": torch.ones(2, 5, 7)}
    with pytest.raises(ValueError, match="conv"):
        reset_recurrent(cache, mask)
    out = reset_recurrent(cache, mask, state_keys=("ssm", ("conv", 0)))
    assert bool((out["ssm"][:, 0] == 0).all())
    assert bool((out["ssm"][:, 1] == 1).all())
    assert bool((out["conv"][0] == 0).all())
    assert bool((out["conv"][1] == 1).all())
    assert out["lengths"].tolist() == [0, 4]


def _requests(cls, vocab, spec, seed=1):
    rng = np.random.default_rng(seed)
    return [cls(prompt=rng.integers(0, vocab, size=n).astype(np.int32),
                max_new_tokens=m) for n, m in spec]


def _both_engines(params, arch, spec, slots, chunk, n_pages=None, **over):
    """The same requests through the JAX engine and the port's; returns
    (jax requests, jax engine, port requests, port engine)."""
    jcfg, tcfg = _cfgs(arch, **over)
    jp, tp = params(arch)
    jeng = JaxEngine(jcfg, jp, batch_slots=slots, max_len=32,
                     chunk_size=chunk, n_pages=n_pages)
    want = jeng.run(_requests(JaxRequest, jcfg.vocab, spec))
    eng = ServeEngine(tcfg, tp, batch_slots=slots, max_len=32,
                      chunk_size=chunk, n_pages=n_pages, device="cpu")
    got = eng.run(_requests(Request, tcfg.vocab, spec))
    return want, jeng, got, eng


def _assert_same(want, jeng, got, eng):
    assert [r.generated for r in got] == [r.generated for r in want]
    assert all(r.status == "finished" and len(r.generated) == r.max_new_tokens
               for r in got)
    stats, jstats = eng.serve_stats(), jeng.serve_stats()
    assert {k: stats[k] for k in COUNTERS} == {k: jstats[k] for k in COUNTERS}


STAGGERED = [(4, 7), (8, 3), (5, 5)]


@pytest.mark.parametrize("arch, over", [
    ("mamba2-1.3b", dict(decode_kernel="pallas_paged")),
    ("mamba2-1.3b", dict(decode_kernel="xla")),
    ("zamba2-2.7b", dict(decode_kernel="pallas_paged")),
    ("zamba2-2.7b", dict(PAGED, decode_kernel="pallas_paged")),
])
def test_engine_streams_equal_jax_engine(params, arch, over):
    """Mixed prompt lengths and staggered budgets: slots park at different
    chunk offsets (tests/test_serve.py); streams and counters equal."""
    _assert_same(*_both_engines(params, arch, STAGGERED, slots=3, chunk=4,
                                **over))


@pytest.mark.parametrize("arch", ARCHS)
def test_slot_reuse_resets_recurrent_state(params, arch):
    """More requests than slots: freed slots re-admit mid-stream with
    their SSM state and conv window zeroed (tests/test_serve.py), so late
    requests match the JAX engine and their own solo runs."""
    spec = [(5, 6), (3, 2), (7, 4), (4, 5), (6, 3)]
    want, jeng, got, eng = _both_engines(params, arch, spec, slots=2,
                                         chunk=2, decode_kernel="pallas_paged")
    _assert_same(want, jeng, got, eng)
    assert eng.stats["admission_waves"] >= 3
    _, tcfg = _cfgs(arch, decode_kernel="pallas_paged")
    _, tp = params(arch)
    solo = ServeEngine(tcfg, tp, batch_slots=2, max_len=32, chunk_size=2,
                       device="cpu")
    late = _requests(Request, tcfg.vocab, spec)[3:4]
    solo.run(late)
    assert late[0].generated == got[3].generated


def test_mamba2_paged_config_falls_back_to_contiguous(params):
    """A paged config on a cache with no KV (mamba2): no allocator, no
    page table and no phantom pool gating admission (n_pages=1 would
    admit one request at a time) (tests/test_serve.py)."""
    spec = [(5, 4), (5, 4), (5, 4)]
    want, jeng, got, eng = _both_engines(
        params, "mamba2-1.3b", spec, slots=2, chunk=2, n_pages=1,
        **dict(PAGED, decode_kernel="pallas_paged"))
    assert not eng.paged and not hasattr(eng, "allocator")
    assert "pages" not in eng.cache
    _assert_same(want, jeng, got, eng)
    assert eng.stats["admission_waves"] == 2
    eng.check_invariants()


def test_zamba2_paged_equals_gather_and_contiguous(params):
    """Torch to torch on a pooled page budget (tests/test_serve.py): the
    paged kernel route emits the gather route's tokens and the contiguous
    ring's, and every page returns to the pool."""
    _, tp = params("zamba2-2.7b")
    spec = [(4, 8), (9, 4), (5, 6), (3, 7)]
    out = {}
    for name, over, n_pages in (
            ("paged", dict(PAGED, decode_kernel="pallas_paged"), 5),
            ("gather", dict(PAGED, decode_kernel="pallas_gather"), 5),
            ("ring", dict(decode_kernel="pallas_paged"), None)):
        _, cfg = _cfgs("zamba2-2.7b", **over)
        eng = ServeEngine(cfg, tp, batch_slots=2, max_len=32, chunk_size=4,
                          n_pages=n_pages, device="cpu")
        out[name] = [r.generated for r in eng.run(
            _requests(Request, cfg.vocab, spec, seed=2))]
        if eng.paged:
            assert sorted(eng.free_pages) == list(range(5))
    assert out["paged"] == out["gather"] == out["ring"]


def test_mamba2_chaos_forced_preemption_equals_jax_engine(params):
    """cfg.chaos_preempt_p force-evicts residents at wave boundaries on a
    layout where page pressure cannot arise (tests/test_lifecycle.py):
    streams, lifecycle counters and the recompute restores equal the JAX
    engine's, and the streams equal the undisturbed run's."""
    spec = [(5, 6), (3, 5), (7, 4), (4, 6)]
    over = dict(decode_kernel="pallas_paged", chaos_preempt_p=0.5,
                chaos_seed=123)
    want, jeng, got, eng = _both_engines(params, "mamba2-1.3b", spec,
                                         slots=2, chunk=2, **over)
    _assert_same(want, jeng, got, eng)
    assert eng.stats["preempted_forced"] >= 1
    assert eng.stats["invariant_checks"] >= eng.stats["admission_waves"]
    _, tcfg = _cfgs("mamba2-1.3b", decode_kernel="pallas_paged")
    plain = ServeEngine(tcfg, params("mamba2-1.3b")[1], batch_slots=2,
                        max_len=32, chunk_size=2, device="cpu")
    calm_reqs = plain.run(_requests(Request, tcfg.vocab, spec))
    assert [r.generated for r in got] == [r.generated for r in calm_reqs]


def test_zamba2_small_pool_preemption_equals_jax_engine(params):
    """A pool below the residents' worst case: the youngest resident is
    preempted and restored by a recompute prefill over prompt + emitted
    tokens (its recurrent state re-zeroed at re-admission); streams and
    counters equal the JAX engine's and no page is left held."""
    spec = [(6, 6), (10, 8), (5, 8), (7, 5)]
    want, jeng, got, eng = _both_engines(
        params, "zamba2-2.7b", spec, slots=2, chunk=2, n_pages=4,
        **dict(PAGED, decode_kernel="pallas_paged", strict_invariants=True))
    _assert_same(want, jeng, got, eng)
    assert eng.stats["preempted"] >= 1
    assert sorted(eng.free_pages) == list(range(4))
    eng.check_invariants()
