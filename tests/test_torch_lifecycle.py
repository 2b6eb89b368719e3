"""The port's engine slice (prefix sharing, preemption, chaos, cancel,
deadlines, bounded queue, invariants) held against the JAX ServeEngine on
the qwen2.5-32b SMOKE config in fp32 with weights bridged from JAX: greedy
streams and lifecycle counters equal, no page leaked.  Also the ports of
``tests/test_prefix.py`` (run against the port's ``PrefixIndex``) and of
the reference's cancel / deadline / backpressure cases, and the logits of
a prefill attached at ``start_lens > 0`` against the JAX model."""
import dataclasses
import time

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
from repro_torch.models import build_model, get_config  # noqa: E402
from repro_torch.serve.chaos import ChaosAllocator  # noqa: E402
from repro_torch.serve.engine import (  # noqa: E402
    AdmissionReject,
    NoProgressError,
    Request,
    ServeEngine,
)
from repro_torch.serve.prefix import PrefixIndex  # noqa: E402

torch.set_num_threads(1)
ARCH = "qwen2.5-32b"
PAGED = dict(cache_layout="paged", kv_page_size=8, decode_splits=2)
SLOTS, MAX_LEN, CHUNK = 3, 48, 2


@pytest.fixture(scope="module")
def jax_params():
    return jax_build(jax_config(ARCH, smoke=True)).init(jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def params(jax_params):
    return convert.from_jax(jax_params, get_config(ARCH, smoke=True), "cpu")


def _workload(cls):
    """Five requests, three of them on one 17-token prefix (two full pages
    of 8): A, B and D share it, C and E do not.  Fresh objects each call."""
    rng = np.random.default_rng(9)
    common = rng.integers(0, 256, 17).astype(np.int32)

    def tail(n):
        return rng.integers(0, 256, n).astype(np.int32)

    spec = [(common, 6), (np.concatenate([common, tail(3)]), 6),
            (tail(10), 8), (np.concatenate([common, tail(5)]), 5),
            (tail(6), 6)]
    return [cls(prompt=p, max_new_tokens=m, id=f"r{i}")
            for i, (p, m) in enumerate(spec)]


# (config overrides, n_pages): small pools force preemption; the chaos
# knobs inject refusals and forced preemptions.
CASES = {
    "preempt": (dict(prefix_sharing=False), 6),
    "preempt_shared": (dict(prefix_sharing=True), 6),
    "chaos_preempt": (dict(prefix_sharing=True, chaos_preempt_p=0.5,
                           chaos_seed=123), None),
    "chaos_alloc_fail": (dict(prefix_sharing=True, chaos_alloc_fail_p=0.4,
                              chaos_seed=0), 8),
    "chaos_share_fail": (dict(prefix_sharing=True, chaos_share_fail_p=0.6,
                              chaos_seed=1), None),
}
COUNTERS = ("preempted", "preempted_forced", "prefix_hits_fresh",
            "admitted_fresh", "readmitted", "prefix_tokens_shared",
            "cancelled", "expired", "admission_waves", "chunks")


def _port_cfg(**over):
    return dataclasses.replace(get_config(ARCH, smoke=True),
                               decode_kernel="pallas_paged",
                               **{**PAGED, **over})


def _run_port(params, over, n_pages):
    eng = ServeEngine(_port_cfg(**over), params, batch_slots=SLOTS,
                      max_len=MAX_LEN, chunk_size=CHUNK, n_pages=n_pages,
                      device="cpu")
    return eng.run(_workload(Request)), eng


@pytest.mark.parametrize("case", list(CASES))
def test_streams_and_counters_equal_jax_engine(jax_params, params, case):
    """Greedy streams equal the JAX engine's (its XLA path) and so do the
    lifecycle counters and injected failures; every page is back on the
    free list and the invariants hold (checked after every wave too when
    a chaos knob is armed)."""
    over, n_pages = CASES[case]
    jcfg = dataclasses.replace(jax_config(ARCH, smoke=True), **PAGED, **over)
    jeng = JaxEngine(jcfg, jax_params, batch_slots=SLOTS, max_len=MAX_LEN,
                     chunk_size=CHUNK, n_pages=n_pages)
    want = jeng.run(_workload(JaxRequest))
    got, eng = _run_port(params, over, n_pages)
    assert [r.generated for r in got] == [r.generated for r in want]
    assert all(r.status == "finished" and len(r.generated) == r.max_new_tokens
               for r in got)
    stats, jstats = eng.serve_stats(), jeng.serve_stats()
    assert {k: stats[k] for k in COUNTERS} == {k: jstats[k] for k in COUNTERS}
    assert stats["prefix_hit_rate"] == jstats["prefix_hit_rate"]
    if hasattr(jeng.allocator, "injected_failures"):
        assert (eng.allocator.injected_failures,
                eng.allocator.injected_share_failures) == (
            jeng.allocator.injected_failures,
            jeng.allocator.injected_share_failures)
    assert sorted(eng.free_pages) == list(range(eng.n_pages))
    eng.check_invariants()
    fired = {"preempt": stats["preempted"],
             "preempt_shared": stats["preempted"] * stats["prefix_hits_fresh"],
             "chaos_preempt": stats["preempted_forced"],
             "chaos_alloc_fail": getattr(eng.allocator, "injected_failures", 0),
             "chaos_share_fail": getattr(eng.allocator,
                                         "injected_share_failures", 0)}
    assert fired[case] > 0, f"{case}: the scenario did not fire"


def test_preemption_off_gates_and_keeps_streams(params):
    """``preemption=False``: a short pool makes heads wait instead; the
    streams are those of the preempting run."""
    want, _ = _run_port(params, dict(prefix_sharing=True), 6)
    got, eng = _run_port(params, dict(prefix_sharing=True,
                                      preemption=False), 6)
    assert [r.generated for r in got] == [r.generated for r in want]
    assert eng.stats["preempted"] == 0
    assert sorted(eng.free_pages) == list(range(eng.n_pages))


def test_strict_invariants_runs_without_chaos(params, monkeypatch):
    monkeypatch.delenv("REPRO_STRICT_INVARIANTS", raising=False)
    _, eng = _run_port(params, {}, None)
    assert eng.stats["invariant_checks"] == 0
    _, eng = _run_port(params, dict(strict_invariants=True), None)
    assert eng.stats["invariant_checks"] >= 1
    monkeypatch.setenv("REPRO_STRICT_INVARIANTS", "1")
    _, eng = _run_port(params, {}, None)
    assert eng.stats["invariant_checks"] >= 1


def test_check_invariants_catches_a_leak(params):
    eng = ServeEngine(_port_cfg(), params, batch_slots=SLOTS,
                      max_len=MAX_LEN, device="cpu")
    eng.check_invariants()
    eng.allocator.alloc(1)                  # held by no slot: a leak
    with pytest.raises(AssertionError, match="leaked"):
        eng.check_invariants()


def test_no_progress_watchdog(params):
    """An alloc-refusal rate just under 1 starves admission; drain()
    raises instead of spinning."""
    eng = ServeEngine(_port_cfg(chaos_alloc_fail_p=1 - 1e-12), params,
                      batch_slots=SLOTS, max_len=MAX_LEN, device="cpu",
                      no_progress_limit=5)
    eng.submit(_workload(Request)[:1])
    with pytest.raises(NoProgressError, match="no progress"):
        eng.drain()


# -- ports of tests/test_lifecycle.py's cancel / deadline / queue cases -----

def _one_slot(params, **kw):
    return ServeEngine(_port_cfg(), params, batch_slots=1, max_len=32,
                       chunk_size=2, device="cpu", **kw)


def test_cancel_queued_and_resident(params):
    eng = _one_slot(params)
    rng = np.random.default_rng(1)
    mk = lambda rid: Request(  # noqa: E731
        prompt=rng.integers(0, 256, 4).astype(np.int32), max_new_tokens=12,
        id=rid)
    resident, queued = mk("res"), mk("qd")
    eng.submit([resident, queued])
    assert eng.step()
    assert resident.status == "resident" and len(resident.generated) >= 1
    assert eng.cancel("qd") and eng.cancel("res")
    assert not eng.cancel("no-such-id")
    eng.drain()
    assert queued.done and queued.status == "cancelled"
    assert queued.generated == []
    assert resident.done and resident.status == "cancelled"
    assert 1 <= len(resident.generated) < resident.max_new_tokens
    assert not eng.cancel("res")
    assert eng.stats["cancelled"] == 2
    assert sorted(eng.free_pages) == list(range(eng.n_pages))
    eng.check_invariants()


def test_deadline_and_queue_wait_expiry(params):
    eng = _one_slot(params)
    rng = np.random.default_rng(2)
    p = lambda: rng.integers(0, 256, 4).astype(np.int32)  # noqa: E731
    slow = Request(prompt=p(), max_new_tokens=24, deadline_s=0.05, id="slow")
    stale = Request(prompt=p(), max_new_tokens=4, max_queue_wait_s=1e-6,
                    id="stale")
    ok = Request(prompt=p(), max_new_tokens=2, deadline_s=60.0, id="ok")
    eng.submit([slow, stale, ok])
    assert eng.step()
    time.sleep(0.06)
    eng.drain()
    assert slow.status == "expired" and 1 <= len(slow.generated) < 24
    assert stale.status == "expired" and stale.generated == []
    assert ok.status == "finished" and len(ok.generated) == 2
    assert eng.stats["expired"] == 2
    assert eng.serve_stats()["goodput_under_deadline"] == pytest.approx(0.5)
    assert sorted(eng.free_pages) == list(range(eng.n_pages))
    eng.check_invariants()


def test_bounded_queue_backpressure(params):
    eng = _one_slot(params, max_queue=2)
    rng = np.random.default_rng(3)
    mk = lambda: Request(  # noqa: E731
        prompt=rng.integers(0, 256, 4).astype(np.int32), max_new_tokens=2)
    with pytest.raises(AdmissionReject, match="max_queue") as ei:
        eng.submit([mk(), mk(), mk()])
    assert ei.value.reason == "queue_full"
    assert len(eng.queue) == 0 and eng.stats["rejected"] == 3
    batch = [mk(), mk()]
    eng.submit(batch)
    eng.drain()
    assert all(r.status == "finished" for r in batch)


def test_chaos_allocator_seeded_and_atomic():
    def pattern(seed):
        alloc = ChaosAllocator(8, fail_p=0.5, seed=seed, share_fail_p=0.5)
        base = alloc.alloc(2) or alloc.alloc(2) or alloc.alloc(2)
        out = []
        for _ in range(12):
            free_before = alloc.free_pages
            refs = {p: alloc.ref_count(p) for p in alloc.held_pages}
            ids = alloc.alloc(1)
            shared = alloc.share(base)
            out.append((ids is None, shared))
            if ids is None:
                assert alloc.free_pages == free_before
            else:
                alloc.release(ids)
            if shared:
                alloc.release(base)
            assert {p: alloc.ref_count(p) for p in alloc.held_pages} == refs
        return out

    assert pattern(3) == pattern(3)
    assert pattern(3) != pattern(4)
    alloc = ChaosAllocator(4, fail_p=1 - 1e-12, seed=0,
                           share_fail_p=1 - 1e-12)
    assert alloc.alloc(0) == [] and alloc.share([]) is True
    assert alloc.injected_failures == alloc.injected_share_failures == 0


# -- a prefill attached at start_lens > 0 against the JAX model -------------

def test_attached_prefill_logits_match_jax(jax_params, params):
    """Slot 1 attaches to slot 0's first two pages and prefills only its
    suffix at cursor 16 (RoPE positions and scatter start there); its
    logits equal the JAX model's over the whole prompt, and so do the
    cursors."""
    over = dict(PAGED, decode_kernel="pallas_paged")
    jcfg = dataclasses.replace(jax_config(ARCH, smoke=True), **over)
    tm = build_model(_port_cfg(), "cpu")
    jm = jax_build(jcfg)
    rng = np.random.default_rng(5)
    prompt = rng.integers(0, 256, 27).astype(np.int32)
    jcache = jm.init_cache(jax_params, batch=1, max_len=32)
    jcache["pages"] = jnp.asarray([[0, 1, 2, 3]], jnp.int32)
    jl, _ = jax.jit(jm.prefill, static_argnames="all_logits")(
        jax_params, jcache, jnp.asarray(prompt[None]), all_logits=True)
    cache = tm.init_cache(params, batch=2, max_len=32)
    cache["pages"] = torch.tensor([[4, 0, 2, -1], [4, 0, 5, 6]],
                                  dtype=torch.int32)
    toks = torch.zeros((2, 27), dtype=torch.int32)
    toks[0, :16] = torch.from_numpy(prompt[:16])
    _, cache = tm.prefill(params, cache, toks,
                          seg_lens=torch.tensor([16, 0], dtype=torch.int32))
    cache["lengths"] = torch.tensor([16, 16], dtype=torch.int32)
    suffix = torch.zeros((2, 11), dtype=torch.int32)
    suffix[1] = torch.from_numpy(prompt[16:])
    tl, cache = tm.prefill(params, cache, suffix,
                           seg_lens=torch.tensor([0, 11], dtype=torch.int32),
                           all_logits=True)
    np.testing.assert_allclose(tl[1].numpy(), np.asarray(jl)[0, 16:],
                               rtol=2e-3, atol=2e-3)
    assert cache["lengths"].tolist() == [16, 27]


# -- ports of tests/test_prefix.py, against the port's PrefixIndex ------

PSZ = 4


def _toks(*chunks):
    """Flatten chunk lists into one token array (np, like r.prompt)."""
    return np.asarray([t for ch in chunks for t in ch], np.int32)


A, B, C, D = (
    [1, 2, 3, 4], [5, 6, 7, 8], [9, 10, 11, 12], [13, 14, 15, 16]
)


def test_prefix_longest_match_lookup():
    idx = PrefixIndex(PSZ)
    idx.register(_toks(A, B, C), [10, 11, 12])
    assert idx.lookup(_toks(A, B, C)) == [10, 11, 12]
    # Divergence after two chunks: longest match is the shared prefix.
    assert idx.lookup(_toks(A, B, D)) == [10, 11]
    assert idx.lookup(_toks(A, D)) == [10]
    assert idx.lookup(_toks(D, A, B)) == []
    # A longer query than the resident chain matches the whole chain.
    assert idx.lookup(_toks(A, B, C, D)) == [10, 11, 12]
    assert len(idx) == 3
    assert idx.resident_tokens() == 3 * PSZ


def test_prefix_partial_page_boundary_never_shared():
    idx = PrefixIndex(PSZ)
    # Register a prompt of 2.5 pages: only the 2 FULL pages may be indexed.
    idx.register(_toks(A, B, [99, 98]), [20, 21])
    assert len(idx) == 2
    # Lookup of 1.75 pages matches only the full first page.
    assert idx.lookup(_toks(A, B[:3])) == [20]
    # A sub-page prompt can never match anything.
    assert idx.lookup(_toks(A[:3])) == []
    # A whole-page query ending at the boundary matches exactly.
    assert idx.lookup(_toks(A, B)) == [20, 21]


def test_prefix_register_keeps_existing_nodes():
    """Re-registering resident content must NOT displace the original
    page (other slots share it); only new chunks register, and the newly
    indexed ids are reported back."""
    idx = PrefixIndex(PSZ)
    assert idx.register(_toks(A, B), [30, 31]) == [30, 31]
    # Same prefix from another slot's table: nothing new registered,
    # lookups keep resolving to the original pages.
    assert idx.register(_toks(A, B), [40, 41]) == []
    assert idx.lookup(_toks(A, B)) == [30, 31]
    # Extending the chain registers only the new tail chunk.
    assert idx.register(_toks(A, B, C), [40, 41, 42]) == [42]
    assert idx.lookup(_toks(A, B, C)) == [30, 31, 42]


def test_prefix_eviction_of_zero_ref_nodes():
    idx = PrefixIndex(PSZ)
    idx.register(_toks(A, B, C), [10, 11, 12])
    idx.register(_toks(A, D), [10, 13])        # sibling branch under A
    assert len(idx) == 4
    # Leaf eviction: the chain shortens, siblings survive.
    assert idx.evict([12]) == 1
    assert idx.lookup(_toks(A, B, C)) == [10, 11]
    assert idx.lookup(_toks(A, D)) == [10, 13]
    # Parent + child freed together (a finishing last sharer): any
    # argument order works — eviction is depth-ordered internally.
    assert idx.evict([10, 13, 11]) == 3
    assert len(idx) == 0
    assert idx.lookup(_toks(A, B)) == []
    # Ids never registered (tail/decode pages) are ignored.
    assert idx.evict([77]) == 0


def test_prefix_evicting_parent_with_resident_child_asserts():
    """A parent page freeing before its child breaks the refcount
    invariant (every sharer holds the whole chain) — fail loudly."""
    idx = PrefixIndex(PSZ)
    idx.register(_toks(A, B), [10, 11])
    with pytest.raises(AssertionError, match="still resident"):
        idx.evict([10])


def test_prefix_readmission_after_release():
    """After a full release/evict cycle the same prompt re-registers
    cleanly under fresh pages — no stale nodes, no page-id aliasing."""
    idx = PrefixIndex(PSZ)
    idx.register(_toks(A, B), [10, 11])
    idx.evict([11, 10])
    assert len(idx) == 0
    # Fresh registration may reuse the very same (recycled) page ids.
    assert idx.register(_toks(A, B), [11, 10]) == [11, 10]
    assert idx.lookup(_toks(A, B)) == [11, 10]


def test_prefix_register_rejects_reused_page_id():
    """One physical page backs exactly one trie node: registering a
    held page under a second prefix is an engine bookkeeping bug."""
    idx = PrefixIndex(PSZ)
    idx.register(_toks(A), [10])
    with pytest.raises(AssertionError, match="already registered"):
        idx.register(_toks(B), [10])
