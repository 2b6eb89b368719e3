"""The port's speculative decode held against the JAX package: the n-gram
proposer on seeded histories, and the engine's greedy streams and exact
speculative counters against the JAX engine's and the port's own plain
streams for the four cache families (rewind: qwen2.5-32b, olmoe-1b-7b;
replay: mamba2-1.3b, zamba2-2.7b) on both layouts, on the SMOKE configs in
fp32 with weights bridged by ``convert.from_jax``.  Random SMOKE weights
rarely repeat themselves (the recurrent families' streams do not), so the
matrix also runs both engines with an oracle proposer that drafts the
known greedy continuation and spoils the last draft of every third
round: every acceptance length, and rollback after it, is exercised.
Also the ports of the reference's spec checks (``tests/test_serve.py``):
spec_k and chunk invariance, history reset at readmission, acceptance
accounting, prefix sharing and preemption under spec."""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import build_model as jax_build  # noqa: E402
from repro.models import get_config as jax_config  # noqa: E402
from repro.serve.draft import ngram_propose as jax_propose  # noqa: E402
from repro.serve.engine import Request as JaxRequest  # noqa: E402
from repro.serve.engine import ServeEngine as JaxEngine  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.models import get_config  # noqa: E402
from repro_torch.serve.draft import ngram_propose  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402

torch.set_num_threads(1)
PAGED = dict(cache_layout="paged", kv_page_size=8)
SPEC = dict(spec_k=3, spec_ngram=2)
SPEC_COUNTERS = ("spec_rounds", "draft_proposed", "draft_accepted",
                 "spec_tokens", "chunks", "admission_waves", "preempted",
                 "decode_tokens")
# The reference's SPEC_WORKLOAD plus one long generation.
WORKLOAD = ((4, 9), (8, 3), (5, 7), (3, 8), (4, 20))


# -- the proposer -------------------------------------------------------------

@pytest.mark.parametrize("ngram, k", [(1, 1), (2, 4), (3, 4), (3, 2)])
@pytest.mark.parametrize("seed", [0, 1])
def test_ngram_propose_matches_jax(seed, ngram, k):
    """Seeded histories over a 3-token vocabulary (so suffixes recur),
    every valid length from 0 to H: drafts equal the JAX proposer's."""
    rng = np.random.default_rng(seed)
    H = 24
    hist = rng.integers(0, 3, (H + 1, H)).astype(np.int32)
    hlen = np.arange(H + 1, dtype=np.int32)
    want = np.asarray(jax_propose(jnp.asarray(hist), jnp.asarray(hlen),
                                  ngram, k))
    got = ngram_propose(torch.from_numpy(hist), torch.from_numpy(hlen),
                        ngram, k)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def _hist(rows, H):
    hist = np.zeros((len(rows), H), np.int32)
    for i, row in enumerate(rows):
        hist[i, :len(row)] = row
    return hist, np.asarray([len(r) for r in rows], np.int32)


@pytest.mark.parametrize("rows, H, ngram, k, want", [
    # tests/test_sampling.py:157: suffix [1, 2, 3] matched at p = 0; no
    # earlier occurrence and a history shorter than the n-gram fall back.
    ([[1, 2, 3, 4, 1, 2, 3], [9, 8, 7, 6], [5, 5]], 12, 3, 4,
     [[4, 1, 2, 3], [6, 6, 6, 6], [5, 5, 5, 5]]),
    # tests/test_sampling.py:174: [7, 8] at p = 0 and p = 3; the later wins.
    ([[7, 8, 1, 7, 8, 2, 0, 7, 8]], 9, 2, 2, [[2, 0]]),
], ids=["suffix_match_and_fallback", "most_recent_match"])
def test_ngram_propose_reference_cases(rows, H, ngram, k, want):
    hist, hlen = _hist(rows, H)
    got = ngram_propose(torch.from_numpy(hist), torch.from_numpy(hlen),
                        ngram, k)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        np.asarray(jax_propose(jnp.asarray(hist), jnp.asarray(hlen),
                               ngram, k)), want)


# -- the engine ---------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _params(arch):
    """(JAX params, the port's bridged copy) of ``arch``'s SMOKE config."""
    jp = jax_build(jax_config(arch, smoke=True)).init(jax.random.PRNGKey(0))
    return jp, convert.from_jax(jp, get_config(arch, smoke=True), "cpu")


def _cfgs(arch, **over):
    return (dataclasses.replace(jax_config(arch, smoke=True), **over),
            dataclasses.replace(get_config(arch, smoke=True),
                                decode_kernel="pallas_paged", **over))


def _requests(cls, vocab, workload=WORKLOAD, seed=1):
    rng = np.random.default_rng(seed)
    return [cls(prompt=rng.integers(0, vocab, size=n).astype(np.int32),
                max_new_tokens=m) for n, m in workload]


def _port_run(cfg, params, reqs, **kw):
    kw = {"batch_slots": 2, "max_len": 32, "chunk_size": 8, **kw}
    eng = ServeEngine(cfg, params, device="cpu", **kw)
    eng.run(reqs)
    return eng, [list(r.generated) for r in reqs]


def _jax_run(cfg, params, reqs, **kw):
    kw = {"batch_slots": 2, "max_len": 32, "chunk_size": 8, **kw}
    eng = JaxEngine(cfg, params, **kw)
    eng.run(reqs)
    return eng, [list(r.generated) for r in reqs]


def _counters(eng):
    return {k: eng.stats[k] for k in SPEC_COUNTERS}


def _oracle_requests(cls, vocab):
    """WORKLOAD with each prompt's first token its index: the oracle finds
    a slot's request by its history's first token."""
    reqs = _requests(cls, vocab)
    for i, r in enumerate(reqs):
        r.prompt[0] = i
    return reqs


def _oracle(seqs, vocab, take, where, arange):
    """A proposer (in either framework's ops) drafting ``seqs[id]`` from
    the slot's history length on: the tokens greedy decode will emit, the
    last one spoiled where ``hist_len % 3 == 0`` (partial acceptance)."""
    width = 64
    table = np.zeros((vocab, width), np.int32)
    for i, seq in enumerate(seqs):
        table[i, :len(seq)] = seq

    def propose(hist, hist_len, ngram, k):
        del ngram
        pos = hist_len[:, None] + arange(k)[None, :]
        drafts = take(table, hist[:, 0], pos.clip(0, width - 1))
        spoil = (hist_len % 3 == 0)[:, None] & (arange(k) == k - 1)[None, :]
        return where(spoil, (drafts + 1) % vocab, drafts)

    return propose


def _jax_oracle(seqs, vocab):
    def take(table, rows, pos):
        return jnp.asarray(table)[rows[:, None], pos]
    return _oracle(seqs, vocab, take, jnp.where, jnp.arange)


def _torch_oracle(seqs, vocab):
    def take(table, rows, pos):
        return torch.from_numpy(table).to(rows.device)[
            rows.long()[:, None], pos.long()]
    return _oracle(seqs, vocab, take, torch.where, torch.arange)


# The n-gram proposer is the same function on either layout, so it runs
# on the paged one; the oracle, which reaches every acceptance length and
# so every rollback, runs on both.
@pytest.mark.parametrize("layout, proposer", [
    ("paged", "ngram"), ("contiguous", "oracle"), ("paged", "oracle")])
@pytest.mark.parametrize("arch", ["qwen2.5-32b", "mamba2-1.3b",
                                  "zamba2-2.7b", "olmoe-1b-7b"])
def test_spec_streams_and_counters_equal_jax_engine(arch, layout, proposer,
                                                    monkeypatch):
    """Port spec == JAX spec == port plain, every request its full budget,
    and the speculative counters equal to the JAX engine's exactly (rounds,
    usable drafts proposed and accepted, tokens).  Two slots over five
    requests re-admit mid-stream; the paged cells run a 5-page pool, whose
    verify passes write past a slot's pages (onto the sink page) at the
    end of each budget."""
    import repro.serve.engine as jax_engine_mod

    import repro_torch.serve.engine as engine_mod

    jp, tp = _params(arch)
    over = dict(PAGED) if layout == "paged" else {}
    kw = {"n_pages": 5} if layout == "paged" else {}
    jcfg, tcfg = _cfgs(arch, **over, **SPEC)
    make = _oracle_requests if proposer == "oracle" else _requests
    _, plain = _port_run(dataclasses.replace(tcfg, spec_k=0), tp,
                         make(Request, tcfg.vocab), **kw)
    if proposer == "oracle":
        seqs = [list(r.prompt) + g
                for r, g in zip(make(Request, tcfg.vocab), plain)]
        monkeypatch.setattr(jax_engine_mod, "ngram_propose",
                            _jax_oracle(seqs, jcfg.vocab))
        monkeypatch.setattr(engine_mod, "ngram_propose",
                            _torch_oracle(seqs, tcfg.vocab))
    jeng, want = _jax_run(jcfg, jp, make(JaxRequest, jcfg.vocab), **kw)
    eng, got = _port_run(tcfg, tp, make(Request, tcfg.vocab), **kw)
    assert got == want == plain
    assert [len(g) for g in got] == [m for _, m in WORKLOAD]
    assert _counters(eng) == _counters(jeng)
    stats = eng.serve_stats()
    assert stats["spec_rounds"] > 0
    assert stats["spec_tokens"] == stats["decode_tokens"]
    if proposer == "oracle":
        assert 0 < stats["draft_accepted"] < stats["draft_proposed"]
        assert stats["spec_tokens_per_round"] > 2
    report = eng.policy_report()["speculative"]
    assert report == jeng.policy_report()["speculative"]
    assert report["rollback"] == ("replay" if arch in ("mamba2-1.3b",
                                                       "zamba2-2.7b")
                                  else "rewind")
    if eng.paged:
        assert sorted(eng.free_pages) == list(range(eng.n_pages))


def test_spec_k_and_chunk_size_invariance():
    """tests/test_serve.py:809: the stream does not depend on how many
    tokens a round drafts or how many rounds a chunk packs."""
    _, tp = _params("qwen2.5-32b")
    base = get_config("qwen2.5-32b", smoke=True)
    outs = []
    for spec_k, chunk in ((1, 4), (3, 8), (6, 28), (3, 56)):
        cfg = dataclasses.replace(base, spec_k=spec_k, spec_ngram=2)
        eng, got = _port_run(cfg, tp, _requests(Request, base.vocab, seed=3),
                             chunk_size=chunk)
        assert eng.spec_rounds == max(1, chunk // (spec_k + 1))
        outs.append(got)
    assert all(o == outs[0] for o in outs[1:])


def test_spec_readmission_resets_history():
    """tests/test_serve.py:825: more requests than slots; a re-admitted
    slot's history holds its own full prompt and first token only (the
    previous occupant's tail is past hist_len), and the streams equal the
    plain engine's."""
    _, tp = _params("qwen2.5-32b")
    cfg = get_config("qwen2.5-32b", smoke=True)
    workload = ((5, 6), (3, 2), (7, 4), (4, 5), (6, 3))
    _, ref = _port_run(cfg, tp, _requests(Request, cfg.vocab, workload, 2))
    eng = ServeEngine(dataclasses.replace(cfg, **SPEC), tp, batch_slots=2,
                      max_len=32, chunk_size=8, device="cpu")
    reqs = _requests(Request, cfg.vocab, workload, 2)
    eng.submit(reqs)
    seen = 0
    while eng.step():
        for slot, r in eng._live():
            n = int(eng.hist_len[slot])
            row = eng.hist[slot, :n].tolist()
            # prompt + emitted, the unconsumed current token last
            assert row == list(r.prompt) + r.generated, r.id
            seen += 1
    assert eng.stats["admission_waves"] >= 3 and seen
    assert [list(r.generated) for r in reqs] == ref


def test_spec_acceptance_accounting():
    """tests/test_serve.py:846 and :1115: a request resumed 16 tokens into
    its own stream (a constant prompt drives the SMOKE model to a fixed
    point) drafts and accepts, emits more than one token a round, and
    ``spec_tokens_per_round`` divides spec-round tokens only."""
    _, tp = _params("qwen2.5-32b")
    cfg = get_config("qwen2.5-32b", smoke=True)
    probe = Request(prompt=np.full(6, 7, np.int32), max_new_tokens=24)
    ServeEngine(cfg, tp, batch_slots=1, max_len=64, device="cpu").run([probe])
    resume = Request(prompt=np.concatenate(
        [probe.prompt, np.asarray(probe.generated[:16], np.int32)]),
        max_new_tokens=8)
    eng = ServeEngine(dataclasses.replace(cfg, **SPEC), tp, batch_slots=1,
                      max_len=64, chunk_size=8, device="cpu")
    eng.run([resume])
    assert resume.generated == probe.generated[16:24]
    stats = eng.serve_stats()
    assert stats["draft_proposed"] > 0
    assert 0.0 < stats["spec_acceptance_rate"] <= 1.0
    assert stats["spec_acceptance_rate"] == (stats["draft_accepted"]
                                             / stats["draft_proposed"])
    assert stats["spec_tokens_per_round"] > 1.0
    assert stats["spec_tokens"] == stats["decode_tokens"]
    eng.stats["decode_tokens"] += 100          # plain tokens do not count
    assert eng.serve_stats()["spec_tokens_per_round"] == (
        stats["spec_tokens_per_round"])


def test_prefix_sharing_composes_with_spec():
    """tests/test_serve.py:674: attached slots draft from their full
    prompt, so sharing changes neither the streams nor the speculative
    counters; the verify writes only private pages (shared pages sit
    below every cursor) and no page leaks."""
    _, tp = _params("qwen2.5-32b")
    cfg = get_config("qwen2.5-32b", smoke=True)
    rng = np.random.default_rng(6)
    sys_p = np.tile(rng.integers(0, cfg.vocab, size=4), 5)[:17].astype(
        np.int32)

    def reqs():
        return [Request(prompt=np.concatenate(
            [sys_p, np.random.default_rng(7 + i).integers(
                0, cfg.vocab, size=3 + i).astype(np.int32)]),
            max_new_tokens=8) for i in range(4)]

    spec_paged = dataclasses.replace(cfg, decode_kernel="pallas_paged",
                                     spec_k=3, **PAGED)
    eng_u, ref = _port_run(spec_paged, tp, reqs(), batch_slots=4)
    shared_cfg = dataclasses.replace(spec_paged, prefix_sharing=True)
    eng_s, got = _port_run(shared_cfg, tp, reqs(), batch_slots=4)
    assert eng_s.prefix_sharing and eng_s.stats["prefix_hits"] == 3
    assert got == ref
    for key in ("draft_proposed", "draft_accepted", "spec_rounds"):
        assert eng_s.stats[key] == eng_u.stats[key], key
    assert eng_s.stats["draft_accepted"] > 0
    assert sorted(eng_s.free_pages) == list(range(eng_s.n_pages))
    eng_s.check_invariants()


@pytest.mark.parametrize("arch", ["qwen2.5-32b", "zamba2-2.7b"])
def test_spec_under_preemption_equals_jax_engine(arch):
    """A short pool with preemption (and prefix sharing where the family
    has it): restores re-seed the history from prompt + emitted, and the
    streams and counters equal the JAX engine's and the plain port's."""
    jp, tp = _params(arch)
    over = dict(PAGED, prefix_sharing=True, preemption=True, **SPEC)
    jcfg, tcfg = _cfgs(arch, **over)
    kw = dict(batch_slots=3, max_len=32, chunk_size=4, n_pages=6)
    jeng, want = _jax_run(jcfg, jp, _requests(JaxRequest, jcfg.vocab), **kw)
    eng, got = _port_run(tcfg, tp, _requests(Request, tcfg.vocab), **kw)
    _, plain = _port_run(dataclasses.replace(tcfg, spec_k=0), tp,
                         _requests(Request, tcfg.vocab), **kw)
    assert got == want == plain
    assert eng.stats["preempted"] > 0
    assert _counters(eng) == _counters(jeng)
    assert sorted(eng.free_pages) == list(range(eng.n_pages))
    eng.check_invariants()
