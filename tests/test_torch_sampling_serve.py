"""The port's engine under seeded temperature / top-k / top-p sampling held
against the JAX engine on SMOKE configs in fp32 (weights bridged by
``convert.from_jax``): streams equal for a dense (yi-9b) and a hybrid
(zamba2) config, plain and speculative (spec_k 4, with an oracle proposer
that drafts the sampled continuation so drafts are accepted), and the
ports of the reference's seeded-sampling checks (``tests/test_serve.py``:
order independence, spec identity with the oracle patched into both
engines, large and negative seeds, the default seed) and of its
preemption identity matrix (``tests/test_lifecycle.py``) with top-p."""
import dataclasses
import functools

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
from repro_torch.models import get_config  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402

torch.set_num_threads(1)
PAGED = dict(cache_layout="paged", kv_page_size=8)
MODES = {"temperature": dict(sampling="temperature", temperature=0.8),
         "top_k": dict(sampling="top_k", top_k=5, temperature=0.9),
         "top_p": dict(sampling="top_p", top_p=0.9, temperature=0.8)}
# (prompt length, budget): two slots over five requests re-admit
# mid-stream.
WORKLOAD = ((4, 9), (8, 3), (5, 7), (3, 8), (4, 12))


@functools.lru_cache(maxsize=None)
def _params(arch):
    """(JAX params, the port's bridged copy) of ``arch``'s SMOKE config."""
    jp = jax_build(jax_config(arch, smoke=True)).init(jax.random.PRNGKey(0))
    return jp, convert.from_jax(jp, get_config(arch, smoke=True), "cpu")


def _cfgs(arch, **over):
    return (dataclasses.replace(jax_config(arch, smoke=True), **over),
            dataclasses.replace(get_config(arch, smoke=True),
                                decode_kernel="pallas_paged", **over))


def _requests(cls, vocab, workload=WORKLOAD, seed=1, numbered=False):
    """Seeded prompts, request i with sampling seed 100 + i; ``numbered``
    sets each prompt's first token to its index (the oracle's key)."""
    rng = np.random.default_rng(seed)
    reqs = [cls(prompt=rng.integers(0, vocab, size=n).astype(np.int32),
                max_new_tokens=m, seed=100 + i)
            for i, (n, m) in enumerate(workload)]
    if numbered:
        for i, r in enumerate(reqs):
            r.prompt[0] = i
    return reqs


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


def _oracle(seqs, vocab, take, where, arange):
    """A proposer (in either framework's ops) drafting ``seqs[id]`` from
    the slot's history length on, the slot's request found by its
    history's first token; the last draft is spoiled where
    ``hist_len % 3 == 0`` (partial acceptance)."""
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


def _torch_oracle(seqs, vocab):
    def take(table, rows, pos):
        return torch.from_numpy(table)[rows.long()[:, None], pos.long()]
    return _oracle(seqs, vocab, take, torch.where, torch.arange)


def _jax_oracle(seqs, vocab):
    def take(table, rows, pos):
        return jnp.asarray(table)[rows[:, None], pos]
    return _oracle(seqs, vocab, take, jnp.where, jnp.arange)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("arch", ["yi-9b", "zamba2-2.7b"])
def test_sampled_streams_equal_jax_engine(arch, mode, monkeypatch):
    """Seeded streams equal the JAX engine's on a paged pool that re-admits
    mid-stream; the speculative engine (spec_k 4; zamba2's rollback is the
    replay) with an oracle proposer drafting those streams accepts drafts
    and emits the same streams: the verify samples position j with the
    key of token index tok_idx + j."""
    import repro_torch.serve.engine as engine_mod

    jp, tp = _params(arch)
    jcfg, tcfg = _cfgs(arch, **PAGED, **MODES[mode])
    _, want = _jax_run(jcfg, jp, _requests(JaxRequest, jcfg.vocab,
                                           numbered=True), n_pages=7)
    _, got = _port_run(tcfg, tp, _requests(Request, tcfg.vocab,
                                           numbered=True), n_pages=7)
    assert got == want
    assert [len(g) for g in got] == [m for _, m in WORKLOAD]
    seqs = [list(r.prompt) + g for r, g in zip(
        _requests(Request, tcfg.vocab, numbered=True), got)]
    monkeypatch.setattr(engine_mod, "ngram_propose",
                        _torch_oracle(seqs, tcfg.vocab))
    eng, spec = _port_run(dataclasses.replace(tcfg, spec_k=4, spec_ngram=3),
                          tp, _requests(Request, tcfg.vocab, numbered=True),
                          n_pages=7, chunk_size=10)
    assert spec == want
    assert 0 < eng.stats["draft_accepted"] < eng.stats["draft_proposed"]
    assert eng.policy_report()["sampling"] == mode


# -- the reference's seeded-sampling checks (tests/test_serve.py) -------------

QWEN = "qwen2.5-32b"


def _qwen_prompts():
    rng = np.random.default_rng(0)
    return [rng.integers(0, 256, size=n).astype(np.int32)
            for n in (4, 6, 5, 7)]


def _seeded(cls, order):
    prompts = _qwen_prompts()
    return [cls(prompt=prompts[i], max_new_tokens=6, seed=100 + i)
            for i in order]


def test_seeded_sampling_order_independent():
    """Re-ordered submissions give every request the same stream (keys
    fold (seed, token index), never the slot), equal to the JAX engine's;
    the seeds do tell the streams apart."""
    jp, tp = _params(QWEN)
    over = dict(sampling="temperature", temperature=0.8)
    jcfg, tcfg = _cfgs(QWEN, **over)

    def run(order):
        reqs = _seeded(Request, order)
        _port_run(tcfg, tp, reqs, chunk_size=4)
        return {r.seed: r.generated for r in reqs}

    first = run([0, 1, 2, 3])
    assert run([3, 1, 0, 2]) == first
    assert len({tuple(v) for v in first.values()}) > 1
    jreqs = _seeded(JaxRequest, [0, 1, 2, 3])
    _jax_run(jcfg, jp, jreqs, chunk_size=4)
    assert {r.seed: r.generated for r in jreqs} == first


def test_seeded_sampling_spec_identity(monkeypatch):
    """Speculative decode under temperature sampling equals plain decode,
    in both engines, with an oracle proposer patched into both engines'
    ``ngram_propose`` so the verify accepts drafts."""
    import repro.serve.engine as jax_engine_mod

    import repro_torch.serve.engine as engine_mod

    jp, tp = _params(QWEN)
    over = dict(sampling="temperature", temperature=0.8)
    jcfg, tcfg = _cfgs(QWEN, **over)

    def numbered(cls):
        reqs = _seeded(cls, [0, 1, 2, 3])
        for i, r in enumerate(reqs):
            r.prompt = r.prompt.copy()
            r.prompt[0] = i
        return reqs

    _, plain = _port_run(tcfg, tp, numbered(Request))
    seqs = [list(r.prompt) + g for r, g in zip(numbered(Request), plain)]
    monkeypatch.setattr(engine_mod, "ngram_propose",
                        _torch_oracle(seqs, tcfg.vocab))
    monkeypatch.setattr(jax_engine_mod, "ngram_propose",
                        _jax_oracle(seqs, jcfg.vocab))
    spec = dict(spec_k=3, spec_ngram=2)
    jeng, jspec = _jax_run(dataclasses.replace(jcfg, **spec), jp,
                           numbered(JaxRequest))
    eng, got = _port_run(dataclasses.replace(tcfg, **spec), tp,
                         numbered(Request))
    assert got == jspec == plain
    assert eng.stats["draft_accepted"] == jeng.stats["draft_accepted"] > 0


def test_large_and_negative_seeds_fold_safely():
    """Seeds from 64-bit hashes or negatives fold into int32 as the
    reference folds them (``seed % 2**31``), reproducibly."""
    jp, tp = _params(QWEN)
    jcfg, tcfg = _cfgs(QWEN, sampling="temperature", temperature=0.9)
    prompt = np.arange(4, dtype=np.int32)

    def run(seed):
        r = Request(prompt=prompt, max_new_tokens=5, seed=seed)
        _port_run(tcfg, tp, [r], batch_slots=1)
        return r.generated

    big = run(2 ** 33 + 5)
    assert big == run(2 ** 33 + 5) == run((2 ** 33 + 5) % 2 ** 31)
    assert run(-3) == run(-3) == run(-3 % 2 ** 31)
    jr = JaxRequest(prompt=prompt, max_new_tokens=5, seed=2 ** 33 + 5)
    _jax_run(jcfg, jp, [jr], batch_slots=1)
    assert jr.generated == big


def test_default_seed_reproducible():
    """Requests without a seed share the default stream (seed 0), in both
    engines."""
    jp, tp = _params(QWEN)
    jcfg, tcfg = _cfgs(QWEN, sampling="top_k", top_k=4, temperature=0.9)
    prompt = np.arange(5, dtype=np.int32)

    def run():
        r = Request(prompt=prompt, max_new_tokens=7)
        _port_run(tcfg, tp, [r], batch_slots=1)
        return r.generated

    first = run()
    assert run() == first
    assert run() == _port_run(tcfg, tp, [Request(
        prompt=prompt, max_new_tokens=7, seed=0)], batch_slots=1)[1][0]
    jr = JaxRequest(prompt=prompt, max_new_tokens=7)
    _jax_run(jcfg, jp, [jr], batch_slots=1)
    assert jr.generated == first


# -- the reference's preemption identity matrix (tests/test_lifecycle.py) -----

# (prompt_len, max_new_tokens) for page_size 8 / max_len 32: A needs 2
# pages, B 3, C 2; on 4 pages B's admission preempts resident A.
_PRESSURE = [(6, 6), (10, 8), (5, 8)]


def _pressure(cls, vocab):
    rng = np.random.default_rng(3)
    return [cls(prompt=rng.integers(0, vocab, size=n).astype(np.int32),
                max_new_tokens=m, seed=11) for n, m in _PRESSURE]


@pytest.mark.parametrize("sampling", ["greedy", "top_p"])
@pytest.mark.parametrize("sharing", [False, True])
def test_preemption_identity_matrix(sampling, sharing):
    """An undersized pool forces at least one preemption; every stream
    equals the uninterrupted run's and the JAX engine's (a restored
    request samples from token index len(generated)), and no page
    leaks."""
    jp, tp = _params("yi-9b")
    over = dict(PAGED, prefix_sharing=sharing)
    if sampling == "top_p":
        over.update(sampling="top_p", top_p=0.9)
    jcfg, tcfg = _cfgs("yi-9b", **over)
    kw = dict(chunk_size=2)
    _, want = _jax_run(jcfg, jp, _pressure(JaxRequest, jcfg.vocab), **kw)
    ref, unpressured = _port_run(tcfg, tp, _pressure(Request, tcfg.vocab),
                                 **kw)
    assert ref.stats["preempted"] == 0
    eng, got = _port_run(tcfg, tp, _pressure(Request, tcfg.vocab),
                         n_pages=4, **kw)
    assert eng.stats["preempted"] >= 1 and eng.stats["recompute_tokens"] >= 1
    assert got == unpressured == want
    assert [len(g) for g in got] == [m for _, m in _PRESSURE]
    assert sorted(eng.free_pages) == list(range(eng.n_pages))
    eng.check_invariants()
