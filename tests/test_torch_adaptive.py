"""The port's adaptive serve-tier cache policy held against the JAX
package: ``AdaptivePolicy`` decision for decision on the same scripted
counters (class keys, deciding classes, quotas, re-plans, reclaim order,
victim costs), and the engine under ``adaptive=True`` on the SMOKE configs
in fp32 with weights bridged by ``convert.from_jax``: streams equal to the
static engine's and the JAX engine's, and the warm, re-plan and prefill
counters equal to the JAX engine's, through the reference's identity
matrix (``tests/test_serve.py:1007``, chaos legs included), cost-aware
preemption (``:1055``) and the four legs of the mixed trace of
``benchmarks/serve_bench.py`` (``adaptive_rows``) at its SMOKE sizes."""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro.models import build_model as jax_build  # noqa: E402
from repro.models import get_config as jax_config  # noqa: E402
from repro.serve import adaptive as jax_adaptive  # noqa: E402
from repro.serve.alloc import PageAllocator as JaxAllocator  # noqa: E402
from repro.serve.engine import Request as JaxRequest  # noqa: E402
from repro.serve.engine import ServeEngine as JaxEngine  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.models import get_config  # noqa: E402
from repro_torch.serve import adaptive  # noqa: E402
from repro_torch.serve.alloc import PageAllocator  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402

torch.set_num_threads(1)
PAGED = dict(cache_layout="paged", kv_page_size=8)
WARM = ("warm_retained", "warm_reclaimed", "warm_hits", "warm_tokens_saved",
        "replans", "prefill_work_tokens", "preempted", "admission_waves",
        "chunks")
REPORT_KEYS = {"enabled", "warm_tier", "warm_pages_now", "warm_retained",
               "warm_reclaimed", "warm_hits", "warm_tokens_saved", "replans",
               "wave", "classes", "combos", "warm_budget"}


# -- the policy alone --------------------------------------------------------

def _script(mod, pinned=None):
    """Drive ``mod.AdaptivePolicy`` through a seeded event sequence (waves,
    arrivals of three prompt classes and the short class, touches,
    retentions, revives, reclaims, re-plans) and record every decision."""
    rng = np.random.default_rng(11)
    pol = mod.AdaptivePolicy(warm_pages=6, replan_every=2, page_size=4,
                             spec_k=3, pinned=pinned)
    prefixes = [tuple(int(t) for t in rng.integers(0, 500, 4))
                for _ in range(3)]
    seen = []
    for wave in range(12):
        pol.begin_wave()
        for _ in range(int(rng.integers(1, 4))):
            c = int(rng.integers(0, 4))
            chunks = [] if c == 3 else [prefixes[c],
                                        tuple(rng.integers(0, 500, 4))]
            key = pol.class_key(chunks)
            n = int(rng.integers(3, 30))
            deciding = pol.note_arrival(key, n, (n - 1) // 4 * 4)
            pages = [int(p) for p in rng.choice(40, 3, replace=False)]
            pol.touch(pages)
            seen.append((key, deciding, pol.retain_quota(key),
                         pol.combo_for(key).to_json()))
            if rng.random() < 0.5:
                pol.note_retained(pages[0], deciding)
                pol.note_retained(pages[1], deciding)
                seen.append(pol.class_warm_count(deciding))
        warm = [int(p) for p in rng.choice(40, 5, replace=False)]
        for p in warm[:3]:
            pol.note_retained(p, "novel")
        seen.append(pol.reclaim_order(warm))
        pol.note_revived(warm[:1])
        pol.note_reclaimed(warm[1:3])
        if pol.should_replan():
            stats = {"spec_rounds": 5, "spec_accepted": 3,
                     "draft_accepted": 4}
            seen.append(pol.replan(stats))
    seen.append(pol.report())
    seen.append(pol.snapshot_state())
    restored = mod.AdaptivePolicy(warm_pages=6, replan_every=2, page_size=4)
    restored.restore_state(pol.snapshot_state())
    seen.append(restored.report())
    return seen


@pytest.mark.parametrize("pinned", [None, (0.5, "reuse", False)],
                         ids=["free", "pinned"])
def test_policy_decisions_equal_reference(pinned):
    """Every decision of the scripted run equals the reference's; a free
    policy re-plans (the novel class among its combos), a pinned one
    never does."""
    got = _script(adaptive, pinned and adaptive.ServeCombo.from_row(pinned))
    want = _script(jax_adaptive,
                   pinned and jax_adaptive.ServeCombo.from_row(pinned))
    assert got == want
    replans = [x for x in got if isinstance(x, dict) and "novel" in x]
    assert bool(replans) == (pinned is None)


def test_victim_cost_equals_reference():
    """Replay tokens less a page's worth per page another slot shares."""
    rec = Request(prompt=np.arange(13, dtype=np.int32), max_new_tokens=9,
                  generated=[1, 2, 3])
    costs = []
    for mod, alloc_cls in ((adaptive, PageAllocator),
                           (jax_adaptive, JaxAllocator)):
        alloc = alloc_cls(8)
        pages = alloc.alloc(4)
        alloc.share(pages[:2])
        pol = mod.AdaptivePolicy(warm_pages=2, replan_every=1, page_size=4)
        costs.append(pol.victim_cost(rec, alloc, pages))
    assert costs == [16 - 8, 16 - 8]


# -- the engine ---------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _params(arch):
    jp = jax_build(jax_config(arch, smoke=True)).init(jax.random.PRNGKey(0))
    return jp, convert.from_jax(jp, get_config(arch, smoke=True), "cpu")


def _cfgs(arch, **over):
    return (dataclasses.replace(jax_config(arch, smoke=True), **over),
            dataclasses.replace(get_config(arch, smoke=True),
                                decode_kernel="pallas_paged", **over))


def _adaptive(warm=3, every=2):
    return dict(adaptive=True, warm_pages=warm, adaptive_replan_every=every)


def _prefix_requests(cls, vocab, sys_len=17, seed=4,
                     spec=((3, 5), (5, 4), (2, 6), (4, 3))):
    """tests/test_serve.py's: one system prompt, each request its tail."""
    rng = np.random.default_rng(seed)
    sys_p = rng.integers(0, vocab, size=sys_len).astype(np.int32)
    return [cls(prompt=np.concatenate(
        [sys_p, rng.integers(0, vocab, size=n).astype(np.int32)]),
        max_new_tokens=m) for n, m in spec]


def _run(engine_cls, req_cls, cfg, params, reqs, **kw):
    kw = {"batch_slots": 2, "max_len": 32, "chunk_size": 4, **kw}
    if engine_cls is ServeEngine:
        kw["device"] = "cpu"
    eng = engine_cls(cfg, params, **kw)
    eng.run(reqs)
    return eng, [list(r.generated) for r in reqs]


def _warm_conserved(eng):
    """Nothing resident: free + warm + quarantined is the whole pool."""
    parts = (sorted(eng.allocator.free_pages)
             + sorted(eng.allocator.warm_pages)
             + sorted(eng.allocator.quarantined_pages))
    assert sorted(parts) == list(range(eng.n_pages))
    eng.check_invariants()


@pytest.mark.parametrize("chaos", [False, True])
@pytest.mark.parametrize("sharing", [False, True])
@pytest.mark.parametrize("arch", ["qwen2.5-32b", "zamba2-2.7b"])
def test_adaptive_identity_matrix(arch, sharing, chaos):
    """tests/test_serve.py:1007: adaptive on equals adaptive off, and the
    port's adaptive engine equals the JAX one in streams and in its warm,
    re-plan and prefill counters (chaos: seeded alloc refusals and forced
    preemptions).  The warm tier engages only for qwen + sharing (the one
    cell with a prefix index), where the report has exactly the
    reference's keys."""
    jp, tp = _params(arch)
    over = dict(PAGED, prefix_sharing=sharing)
    _, ref = _run(ServeEngine, Request, _cfgs(arch, **over)[1], tp,
                  _prefix_requests(Request, 256))
    if chaos:
        over.update(chaos_alloc_fail_p=0.3, chaos_preempt_p=0.3,
                    chaos_seed=3)
    jcfg, tcfg = _cfgs(arch, **over, **_adaptive(every=1))
    jeng, want = _run(JaxEngine, JaxRequest, jcfg, jp,
                      _prefix_requests(JaxRequest, jcfg.vocab))
    eng, got = _run(ServeEngine, Request, tcfg, tp,
                    _prefix_requests(Request, tcfg.vocab))
    assert got == want == ref
    assert {k: eng.stats[k] for k in WARM} == {k: jeng.stats[k]
                                               for k in WARM}
    rep = eng.policy_report()["adaptive"]
    assert rep == jeng.policy_report()["adaptive"]
    assert set(rep) == REPORT_KEYS and rep["enabled"]
    assert eng.stats["replans"] >= 1
    if sharing and eng.prefix_sharing:
        assert rep["warm_tier"]
        assert eng.stats["warm_retained"] >= 1
        assert eng.stats["warm_hits"] >= 1
    else:
        assert eng.stats["warm_retained"] == 0 and not rep["warm_tier"]
    if chaos:
        assert eng.stats["preempted_forced"] + getattr(
            eng.allocator, "injected_failures", 0) > 0
    _warm_conserved(eng)


def test_adaptive_cost_aware_preemption_identity():
    """tests/test_serve.py:1055: in an undersized pool the cost-aware
    victim may differ from youngest-first, but recompute-restore keeps
    every stream, natural preemptions stay bounded, and the counters equal
    the JAX engine's."""
    arch = "qwen2.5-32b"
    jp, tp = _params(arch)
    spec = [(6, 6), (10, 8), (5, 8)]

    def reqs(cls):
        rng = np.random.default_rng(3)
        return [cls(prompt=rng.integers(0, 256, size=n).astype(np.int32),
                    max_new_tokens=m) for n, m in spec]

    over = dict(PAGED, prefix_sharing=True)
    _, ref = _run(ServeEngine, Request, _cfgs(arch, **over)[1], tp,
                  reqs(Request), chunk_size=2)
    jcfg, tcfg = _cfgs(arch, **over, **_adaptive(warm=2, every=1))
    jeng, want = _run(JaxEngine, JaxRequest, jcfg, jp, reqs(JaxRequest),
                      chunk_size=2, n_pages=4)
    eng, got = _run(ServeEngine, Request, tcfg, tp, reqs(Request),
                    chunk_size=2, n_pages=4)
    assert eng.stats["preempted"] >= 1
    assert got == want == ref
    assert {k: eng.stats[k] for k in WARM} == {k: jeng.stats[k]
                                               for k in WARM}
    assert all(r.preempted_n <= 1 for r in eng._by_id.values())
    _warm_conserved(eng)


# benchmarks/serve_bench.py's mixed trace at its SMOKE sizes.
ADAPT = dict(page=16, sys=48, tail=4, new=8, junk=36, junk_new=4, warm=3,
             pool=8, rounds=6, slots=2, max_len=80)


def _mixed_trace(eng, req_cls, vocab, pinned=None):
    """ADAPT rounds of one re-arriving system-prompt request beside one
    never-repeated junk request (``serve_bench._mixed_trace``)."""
    if pinned is not None:
        eng.adaptive.pinned = pinned
    rng = np.random.default_rng(5)
    sys_p = rng.integers(0, vocab, size=ADAPT["sys"]).astype(np.int32)
    outs = []
    for _ in range(ADAPT["rounds"]):
        junk = req_cls(prompt=rng.integers(0, vocab, size=ADAPT["junk"])
                       .astype(np.int32), max_new_tokens=ADAPT["junk_new"])
        sysr = req_cls(prompt=np.concatenate(
            [sys_p, rng.integers(0, vocab, size=ADAPT["tail"])
             .astype(np.int32)]), max_new_tokens=ADAPT["new"])
        eng.submit([junk, sysr])
        eng.drain()
        outs.append((list(junk.generated), list(sysr.generated)))
    _warm_conserved(eng)
    return outs


def test_mixed_trace_four_legs():
    """serve_bench.adaptive_rows: static_off, pinned retain-always, pinned
    bypass and the free-running adaptive engine emit the same streams;
    adaptive does no more prefill work than the best static leg and less
    than static_off, re-plans, revives warm pages and teaches the novel
    class bypass; every leg's counters equal the JAX engine's."""
    arch = "qwen2.5-32b"
    jp, tp = _params(arch)
    shared = dict(cache_layout="paged", kv_page_size=ADAPT["page"],
                  prefix_sharing=True)
    adapt = dict(shared, adaptive=True, warm_pages=ADAPT["warm"],
                 adaptive_replan_every=1)
    legs = {"static_off": (shared, None),
            "static_retain": (adapt, (1.0, "lru", False)),
            "static_bypass": (adapt, (1.0, "lru", True)),
            "adaptive": (adapt, None)}
    kw = dict(batch_slots=ADAPT["slots"], max_len=ADAPT["max_len"],
              chunk_size=4, n_pages=ADAPT["pool"])
    work, outs, engines = {}, {}, {}
    for name, (over, pinned) in legs.items():
        jcfg, tcfg = _cfgs(arch, **over)
        eng = ServeEngine(tcfg, tp, device="cpu", **kw)
        outs[name] = _mixed_trace(eng, Request, tcfg.vocab, pinned and
                                  adaptive.ServeCombo.from_row(pinned))
        jeng = JaxEngine(jcfg, jp, **kw)
        want = _mixed_trace(jeng, JaxRequest, jcfg.vocab, pinned and
                            jax_adaptive.ServeCombo.from_row(pinned))
        assert outs[name] == want, name
        assert {k: eng.stats[k] for k in WARM} == {
            k: jeng.stats[k] for k in WARM}, name
        work[name], engines[name] = eng.stats["prefill_work_tokens"], eng
    assert all(o == outs["static_off"] for o in outs.values())
    best_static = min(v for k, v in work.items() if k != "adaptive")
    assert work["adaptive"] <= best_static
    assert work["adaptive"] < work["static_off"]
    eng = engines["adaptive"]
    assert eng.stats["replans"] >= 1 and eng.stats["warm_hits"] >= 1
    novel = eng.policy_report()["adaptive"]["combos"].get(adaptive.CLASS_NOVEL)
    assert novel is not None and novel[2] is True
