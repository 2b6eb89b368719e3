"""The port's crash safety and KV page integrity held against the JAX
engine: the ports of every case of ``tests/test_snapshot.py`` with the
restored streams equal to the reference engine's uninterrupted run;
snapshots and journals restoring across the two packages in both
directions; ``kv_integrity`` and ``chaos_corrupt_p`` runs with the
reference's counters, corrupted and quarantined pages; and a restore that
resets every static buffer in place (no ``data_ptr`` moves, the rebinding
guard passes, the buffers equal a fresh engine's).  yi-9b SMOKE, fp32,
weights bridged by ``convert.from_jax``."""
import dataclasses
import functools
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro.models import build_model as jax_build  # noqa: E402
from repro.models import get_config as jax_config  # noqa: E402
from repro.serve.engine import Request as JaxRequest  # noqa: E402
from repro.serve.engine import ServeEngine as JaxEngine  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.models import get_config  # noqa: E402
from repro_torch.serve.chaos import ChaosCrash  # noqa: E402
from repro_torch.serve.engine import (  # noqa: E402
    NoProgressError,
    Request,
    ServeEngine,
    _leaves,
)
from repro_torch.serve.snapshot import (  # noqa: E402
    RequestJournal,
    SnapshotError,
    load_snapshot,
    write_snapshot,
)

torch.set_num_threads(1)
ARCH = "yi-9b"
_PRESSURE = [(6, 6), (10, 8), (5, 8)]
PAGED = dict(cache_layout="paged", kv_page_size=8)


@functools.lru_cache(maxsize=None)
def _params():
    jp = jax_build(jax_config(ARCH, smoke=True)).init(jax.random.PRNGKey(0))
    return jp, convert.from_jax(jp, get_config(ARCH, smoke=True), "cpu")


def _cfg(kernel="pallas_paged", **kw):
    """The port's config: yi-9b SMOKE, paged, on the kernel route (or on
    ``"xla"``, the JAX config's route, where a snapshot must cross)."""
    return dataclasses.replace(get_config(ARCH, smoke=True), **PAGED,
                               decode_kernel=kernel, **kw)


def _jax_cfg(**kw):
    return dataclasses.replace(jax_config(ARCH, smoke=True), **PAGED, **kw)


def _reqs(cls, spec=_PRESSURE, seed=0, rng_seed=3):
    rng = np.random.default_rng(rng_seed)
    return [cls(prompt=rng.integers(0, 256, size=n).astype(np.int32),
                max_new_tokens=m, seed=seed) for n, m in spec]


def _engine(cfg, **kw):
    return ServeEngine(cfg, _params()[1], batch_slots=2, max_len=32,
                       chunk_size=2, device="cpu", **kw)


def _jax_engine(cfg, **kw):
    return JaxEngine(cfg, _params()[0], batch_slots=2, max_len=32,
                     chunk_size=2, **kw)


@functools.lru_cache(maxsize=None)
def _reference(seed, spec=tuple(_PRESSURE), **over):
    """The JAX engine's uninterrupted streams by request id."""
    reqs = _reqs(JaxRequest, list(spec), seed=seed)
    _jax_engine(_jax_cfg(**over)).run(reqs)
    return {r.id: list(r.generated) for r in reqs}


def _assert_zero_leaks(eng):
    free = sorted(eng.free_pages)
    quar = sorted(eng.allocator.quarantined_pages)
    assert sorted(free + quar) == list(range(eng.n_pages)), (free, quar)
    eng.check_invariants()


@pytest.mark.parametrize("sharing, sampling", [
    (False, {}), (True, {}),
    (False, dict(sampling="top_p", top_p=0.9, temperature=0.8))])
def test_snapshot_restore_mid_wave_identity(sharing, sampling, tmp_path):
    """A snapshot taken mid-stream (requests resident, queued and
    finished), restored into a fresh engine, finishes with the JAX
    engine's uninterrupted streams and no page leaked; residents re-attach
    through the trie with sharing on, and a restored sampled stream
    resumes at token index len(generated)."""
    over = dict(prefix_sharing=sharing, **sampling)
    want = _reference(5, **over)
    got = _reqs(Request, seed=5)
    e1 = _engine(_cfg(**over))
    e1.submit(got)
    for _ in range(3):
        e1.step()
    spath = str(tmp_path / "mid.json")
    info = e1.snapshot(spath)
    assert info["requests"] == len(got)
    assert info["in_flight"] >= 1, "snapshot point was not mid-stream"
    e2 = _engine(_cfg(**over))
    assert e2.restore(spath)["restored"] == info["in_flight"]
    e2.drain()
    assert e2.results() == want
    _assert_zero_leaks(e2)


def test_journal_replay_after_injected_kill(tmp_path):
    """chaos_crash_after_wave kills the engine at a flushed chunk boundary
    (at the same wave as the JAX engine's); a fresh engine recovers from
    the journal alone and finishes with the uninterrupted streams."""
    want = _reference(7)
    jpath = str(tmp_path / "j.jsonl")
    e1 = _engine(_cfg(chaos_crash_after_wave=1), journal_path=jpath)
    e1.submit(_reqs(Request, seed=7))
    with pytest.raises(ChaosCrash) as ei:
        e1.drain()
    j1 = _jax_engine(_jax_cfg(chaos_crash_after_wave=1))
    j1.submit(_reqs(JaxRequest, seed=7))
    with pytest.raises(Exception) as ji:
        j1.drain()
    assert type(ji.value).__name__ == "ChaosCrash"
    assert ei.value.wave == ji.value.wave >= 1
    assert e1.results() == j1.results()
    e2 = _engine(_cfg(), journal_path=jpath)
    assert e2.restore()["replayed_events"] >= len(_PRESSURE)
    e2.drain()
    assert e2.results() == want
    _assert_zero_leaks(e2)


def test_snapshot_plus_journal_suffix(tmp_path):
    """Snapshot after one step, crash later: restore loads the snapshot
    and replays only the journal past its offset; terminal events
    re-retire finished requests with their exact streams."""
    want = _reference(9)
    jpath, spath = str(tmp_path / "j.jsonl"), str(tmp_path / "s.json")
    e1 = _engine(_cfg(chaos_crash_after_wave=2), journal_path=jpath)
    e1.submit(_reqs(Request, seed=9))
    e1.step()
    e1.snapshot(spath)
    with pytest.raises(ChaosCrash):
        e1.drain()
    e2 = _engine(_cfg(), journal_path=jpath)
    rep = e2.restore(spath)
    e2.drain()
    assert e2.results() == want
    assert rep["restored"] >= 1
    _assert_zero_leaks(e2)


def test_terminal_results_survive_restore(tmp_path):
    """Requests finished before the snapshot come back terminal, status
    and streams intact (the JAX engine's), never re-admitted."""
    got = _reqs(Request, spec=[(6, 4)], seed=3)
    e1 = _engine(_cfg())
    e1.run(got)
    assert e1.results() == _reference(3, spec=((6, 4),))
    spath = str(tmp_path / "done.json")
    e1.snapshot(spath)
    e2 = _engine(_cfg())
    assert e2.restore(spath) == {"restored": 0, "replayed_events": 0,
                                 "terminal": 1}
    r = e2.request(got[0].id)
    assert r.done and r.status == "finished"
    assert r.generated == got[0].generated
    assert not e2.step()


def test_corrupted_snapshot_rejected_with_typed_error(tmp_path):
    """Every tampering mode maps to its SnapshotError.reason, and a
    rejected restore leaves the live engine intact and serving."""
    e1 = _engine(_cfg())
    e1.run(_reqs(Request, spec=[(6, 4)], seed=1))
    spath = str(tmp_path / "s.json")
    e1.snapshot(spath)

    def tampered(mutate, name):
        doc = json.load(open(spath))
        mutate(doc)
        p = str(tmp_path / name)
        json.dump(doc, open(p, "w"))
        return p

    cases = [
        ("checksum", tampered(
            lambda d: d["payload"]["counters"].__setitem__(
                "next_id", d["payload"]["counters"]["next_id"] + 1),
            "flip.json")),
        ("bad_magic", tampered(
            lambda d: d.__setitem__("magic", "nope"), "magic.json")),
        ("version", tampered(
            lambda d: d.__setitem__("version", 999), "ver.json")),
        ("unreadable", str(tmp_path / "absent.json")),
    ]
    trunc = str(tmp_path / "trunc.json")
    open(trunc, "w").write(open(spath).read()[:40])
    cases.append(("unreadable", trunc))

    victim = _engine(_cfg())
    victim.submit(_reqs(Request, spec=[(6, 4)], seed=2))
    victim.step()
    before = victim.results()
    for reason, path in cases:
        with pytest.raises(SnapshotError) as ei:
            victim.restore(path)
        assert ei.value.reason == reason, (reason, ei.value.reason)
    assert victim.results() == before
    victim.drain()
    assert all(r.done for r in victim._by_id.values())
    assert victim.results() == _reference(2, spec=((6, 4),))


def test_restore_rejects_config_and_geometry_mismatch(tmp_path):
    e1 = _engine(_cfg())
    e1.run(_reqs(Request, spec=[(6, 4)], seed=1))
    spath = str(tmp_path / "s.json")
    e1.snapshot(spath)
    other = _engine(_cfg(sampling="top_p", top_p=0.9))
    with pytest.raises(SnapshotError) as ei:
        other.restore(spath)
    assert ei.value.reason == "config_mismatch"
    # Chaos and strict knobs are outside the fingerprint.
    _engine(_cfg(chaos_crash_after_wave=7, strict_invariants=True)).restore(
        spath)
    small = ServeEngine(_cfg(), _params()[1], batch_slots=2, max_len=32,
                        chunk_size=2, n_pages=4, device="cpu")
    with pytest.raises(SnapshotError) as ei:
        small.restore(spath)
    assert ei.value.reason == "geometry_mismatch"
    with pytest.raises(SnapshotError) as ei:
        _engine(_cfg()).restore()
    assert ei.value.reason == "no_source"


def test_inconsistent_snapshot_audit(tmp_path):
    """Refcounts that disagree with the page tables are rejected by the
    audit although the checksum is valid (written corrupt, not torn)."""
    e1 = _engine(_cfg())
    e1.submit(_reqs(Request, seed=4))
    e1.step()
    spath = str(tmp_path / "s.json")
    e1.snapshot(spath)
    payload = load_snapshot(spath)
    assert payload["allocator"]["refcounts"], "no held pages to corrupt"
    k = next(iter(payload["allocator"]["refcounts"]))
    payload["allocator"]["refcounts"][k] += 1
    write_snapshot(spath, payload)
    with pytest.raises(SnapshotError) as ei:
        _engine(_cfg()).restore(spath)
    assert ei.value.reason == "inconsistent"


def test_quarantine_persists_across_restore(tmp_path):
    e1 = _engine(_cfg())
    e1.run(_reqs(Request, spec=[(6, 4)], seed=1))
    for p in (2, 5):
        assert e1.allocator.quarantine(p)
    spath = str(tmp_path / "q.json")
    e1.snapshot(spath)
    e2 = _engine(_cfg())
    e2.restore(spath)
    assert sorted(e2.allocator.quarantined_pages) == [2, 5]
    assert e2.allocator.usable_pages() == e2.n_pages - 2
    e2.check_invariants()


def test_journal_skips_torn_trailing_line(tmp_path):
    jpath = str(tmp_path / "j.jsonl")
    j = RequestJournal(jpath)
    j.append({"ev": "submit", "id": "a"})
    j.append({"ev": "terminal", "id": "a", "status": "finished",
              "generated": [1, 2]})
    off = j.offset()
    j.close()
    with open(jpath, "a") as f:
        f.write('{"ev": "submit", "id": "b", "pro')
    assert [e["id"] for e in RequestJournal.replay(jpath)] == ["a", "a"]
    assert list(RequestJournal.replay(jpath, offset=off)) == []
    with pytest.raises(SnapshotError) as ei:
        list(RequestJournal.replay(str(tmp_path / "absent.jsonl")))
    assert ei.value.reason == "unreadable"


def test_drain_watchdog_raises_no_progress():
    """A fully quarantined pool never admits: drain() raises after the
    configured zero-progress steps, and the engine stays inspectable."""
    eng = _engine(_cfg(), no_progress_limit=4)
    eng.submit(_reqs(Request, spec=[(6, 4)], seed=1))
    for p in list(eng.allocator.free_pages):
        eng.allocator.quarantine(p)
    with pytest.raises(NoProgressError) as ei:
        eng.drain()
    assert "no progress" in str(ei.value) and "usable_pages" in str(ei.value)
    assert eng.allocator.usable_pages() == 0


ADAPTIVE = dict(prefix_sharing=True, adaptive=True, warm_pages=2,
                adaptive_replan_every=1)
CARRIED = ("admission_waves", "prefill_tokens", "decode_tokens",
           "admitted_fresh", "readmitted", "prefill_work_tokens",
           "prefix_hits", "prefix_hits_fresh", "warm_retained", "warm_hits",
           "warm_reclaimed", "replans", "preempted")


def test_counters_and_adaptive_state_survive_restore(tmp_path):
    """The crashed engine's counters and the adaptive controller's learned
    class state (equal to the JAX engine's at the same point) carry into
    the restored engine; warm pages do not.  The recovered run finishes
    with the uninterrupted streams."""
    want = _reference(5, **ADAPTIVE)
    got = _reqs(Request, seed=5)
    e1 = _engine(_cfg(**ADAPTIVE))
    e1.submit(got)
    j1 = _jax_engine(_jax_cfg(**ADAPTIVE))
    j1.submit(_reqs(JaxRequest, seed=5))
    for _ in range(3):
        e1.step()
        j1.step()
    pre = dict(e1.stats)
    pre_adaptive = e1.adaptive.snapshot_state()
    assert {k: pre[k] for k in CARRIED} == {k: j1.stats[k] for k in CARRIED}
    assert pre_adaptive == j1.adaptive.snapshot_state()
    assert pre["admission_waves"] >= 1
    spath = str(tmp_path / "adaptive.json")
    assert e1.snapshot(spath)["in_flight"] >= 1
    e2 = _engine(_cfg(**ADAPTIVE))
    e2.restore(spath)
    for key in CARRIED:
        assert e2.stats[key] == pre[key], key
    assert e2.adaptive.snapshot_state() == pre_adaptive
    assert e2.adaptive.wave == e1.adaptive.wave
    assert e2.allocator.warm_count() == 0, "warm pages must not survive"
    e2.drain()
    assert e2.results() == want
    free, warm = sorted(e2.allocator.free_pages), sorted(
        e2.allocator.warm_pages)
    assert sorted(free + warm) == list(range(e2.n_pages))
    e2.check_invariants()


def test_adaptive_crash_recovery_identity(tmp_path):
    """A kill mid-run with the adaptive tier live, journal-only recovery
    into a fresh adaptive engine, then a static engine restoring the
    adaptive engine's snapshot (the adaptive knobs are outside the
    fingerprint): the uninterrupted streams throughout."""
    want = _reference(7, **ADAPTIVE)
    jpath = str(tmp_path / "aj.jsonl")
    e1 = _engine(_cfg(chaos_crash_after_wave=1, **ADAPTIVE),
                 journal_path=jpath)
    e1.submit(_reqs(Request, seed=7))
    with pytest.raises(ChaosCrash):
        e1.drain()
    e2 = _engine(_cfg(**ADAPTIVE), journal_path=jpath)
    e2.restore()
    e2.drain()
    assert e2.results() == want
    spath = str(tmp_path / "cross.json")
    e2.snapshot(spath)
    e3 = _engine(_cfg(prefix_sharing=True))
    e3.restore(spath)
    assert e3.adaptive is None
    assert e3.results() == want
    e3.check_invariants()


# -- across the packages ------------------------------------------------------

@pytest.mark.parametrize("writer", ["jax", "port"])
def test_snapshot_and_journal_restore_across_packages(writer, tmp_path):
    """A snapshot and journal written by one package, mid-stream and then
    killed, restore in the other (both on the plain route, so the
    configs' fingerprints agree), which finishes with the uninterrupted
    streams and no page leaked."""
    over = dict(sampling="top_p", top_p=0.9, temperature=0.8)
    want = _reference(13, **over)
    jpath, spath = str(tmp_path / "j.jsonl"), str(tmp_path / "s.json")
    if writer == "jax":
        e1 = _jax_engine(_jax_cfg(chaos_crash_after_wave=2, **over),
                         journal_path=jpath)
        reqs = _reqs(JaxRequest, seed=13)
    else:
        e1 = _engine(_cfg("xla", chaos_crash_after_wave=2, **over),
                     journal_path=jpath)
        reqs = _reqs(Request, seed=13)
    e1.submit(reqs)
    e1.step()
    info = e1.snapshot(spath)
    assert info["in_flight"] >= 1
    with pytest.raises(Exception) as ei:
        e1.drain()
    assert type(ei.value).__name__ == "ChaosCrash"
    if writer == "jax":
        e2 = _engine(_cfg("xla", **over), journal_path=jpath)
    else:
        e2 = _jax_engine(_jax_cfg(**over), journal_path=jpath)
    rep = e2.restore(spath)
    assert rep["replayed_events"] >= 1
    e2.drain()
    assert e2.results() == want
    _assert_zero_leaks(e2)


# -- KV page integrity --------------------------------------------------------

INTEGRITY = {
    "stamps": dict(kv_integrity=True),
    "corrupt": dict(chaos_corrupt_p=0.5, chaos_seed=4),
    "corrupt_shared": dict(chaos_corrupt_p=0.4, chaos_seed=1,
                           prefix_sharing=True),
}
INTEGRITY_COUNTERS = ("integrity_sweeps", "corrupted_pages",
                      "healed_requests", "injected_corruptions", "preempted",
                      "readmitted", "recompute_tokens", "admission_waves",
                      "chunks", "decode_tokens", "prefill_tokens",
                      "invariant_checks")


def _integrity_requests(cls):
    """Prompts of 9-20 tokens (pages of 8 seal early), three on one
    17-token prefix."""
    rng = np.random.default_rng(21)
    common = rng.integers(0, 256, 17).astype(np.int32)
    prompts = [common, rng.integers(0, 256, 12).astype(np.int32),
               np.concatenate([common, rng.integers(0, 256, 3)]).astype(
                   np.int32),
               rng.integers(0, 256, 9).astype(np.int32),
               np.concatenate([common, rng.integers(0, 256, 1)]).astype(
                   np.int32)]
    return [cls(prompt=p, max_new_tokens=10, id=f"r{i}")
            for i, p in enumerate(prompts)]


@pytest.mark.parametrize("case", list(INTEGRITY))
def test_integrity_counters_and_quarantine_equal_jax(case):
    """The on-device fingerprints stamp, verify and find corrupt the same
    pages as the reference's host CRC32: equal streams (corruption healed
    by recompute), integrity and lifecycle counters, quarantined pages and
    integrity report; host syncs equal but for the reference's second
    pull after each injected flip."""
    over = INTEGRITY[case]
    kw = dict(batch_slots=3, max_len=48, chunk_size=2)
    jeng = JaxEngine(_jax_cfg(**over), _params()[0], **kw)
    want = jeng.run(_integrity_requests(JaxRequest))
    eng = ServeEngine(_cfg(**over), _params()[1], device="cpu", **kw)
    got = eng.run(_integrity_requests(Request))
    assert [r.generated for r in got] == [r.generated for r in want]
    assert all(len(r.generated) == r.max_new_tokens for r in got)
    stats, jstats = eng.stats, jeng.stats
    assert ({k: stats[k] for k in INTEGRITY_COUNTERS}
            == {k: jstats[k] for k in INTEGRITY_COUNTERS})
    assert stats["host_syncs"] == (jstats["host_syncs"]
                                   - jstats["injected_corruptions"])
    assert eng.allocator.quarantined_pages == jeng.allocator.quarantined_pages
    assert eng.policy_report()["integrity"] == jeng.policy_report()[
        "integrity"]
    assert stats["integrity_sweeps"] > 0
    if "chaos_corrupt_p" in over:
        assert stats["injected_corruptions"] > 0
        assert stats["corrupted_pages"] >= stats["injected_corruptions"]
        assert stats["healed_requests"] > 0
    _assert_zero_leaks(eng)


def test_verify_pages_finds_a_flipped_page():
    """A stamped page flipped on the device (as ``_corrupt_page`` flips
    it) is found by ``verify_pages``, quarantined (doomed while held), and
    its slot healed by recompute; an unflipped pool verifies clean."""
    eng = ServeEngine(_cfg(kv_integrity=True), _params()[1], batch_slots=3,
                      max_len=48, chunk_size=2, device="cpu")
    eng.submit(_integrity_requests(Request)[:2])
    for _ in range(3):
        eng.step()
    assert eng._stamped and eng.verify_pages() == []
    page = min(eng._stamped)
    holder = next(r for slot, r in eng._live()
                  if page in eng._slot_pages[slot])
    eng._corrupt_page(page)
    assert eng.verify_pages() == [page]
    assert page in eng.allocator.quarantined_pages | eng.allocator.doomed_pages
    assert holder.status == "preempted" and eng.stats["healed_requests"] == 1
    eng.drain()
    _assert_zero_leaks(eng)
    assert page in eng.allocator.quarantined_pages


# -- a restore in place -------------------------------------------------------

def test_restore_resets_static_buffers_in_place(tmp_path):
    """``restore`` resets the static buffers in place: no buffer's
    ``data_ptr`` moves, ``_check_static`` passes (a captured graph stays
    valid), every buffer equals a fresh engine's bitwise, and the
    restored run then serves the uninterrupted top-p streams of a
    speculative engine."""
    over = dict(spec_k=2, sampling="top_p", top_p=0.9, temperature=0.8)
    e1 = _engine(_cfg(**over))
    e1.submit(_reqs(Request, seed=5))
    for _ in range(3):
        e1.step()
    spath = str(tmp_path / "s.json")
    e1.snapshot(spath)
    ptrs = e1._static_ptrs()
    captured = e1.stats["captured_launches"], e1.stats["graph_pool_bytes"]
    e1._hard_reset()
    assert e1._static_ptrs() == ptrs
    e1._check_static()
    fresh = _engine(_cfg(**over))
    for (path, a), (_, b) in zip(_leaves(e1.cache), _leaves(fresh.cache),
                                 strict=True):
        assert torch.equal(a, b), path
    for name in ("cur_tok", "remaining", "seeds", "tok_idx", "_out", "hist",
                 "hist_len", "_spec_out"):
        assert torch.equal(getattr(e1, name), getattr(fresh, name)), name
    e1.restore(spath)
    assert e1._static_ptrs() == ptrs
    assert (e1.stats["captured_launches"],
            e1.stats["graph_pool_bytes"]) == captured
    e1.drain()
    assert e1._static_ptrs() == ptrs
    assert e1.results() == _reference(5, **over)
