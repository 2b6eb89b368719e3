"""The serve engine's static-buffer decode chunk, the body of its CUDA graph:
in-place slot resets bitwise equal to the functional ones, no captured
buffer rebound through admission waves, preemption, cancel and prefix
attach (the speculative chunk's history, output and recurrent scratch
too, and the adaptive policy's warm revives), the guard that raises when
one is, and the kernel counters a replay advances.  The graph itself needs a card: the ``cuda`` cases hold
graphed streams bitwise equal to the eager loop's on one and skip
without one."""
import dataclasses
import importlib.util
import pathlib
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import convert  # noqa: E402
from repro_torch.kernels import counters  # noqa: E402
from repro_torch.kernels.decode_attention import decode_attention as dk  # noqa: E402
from repro_torch.kernels.moe_gmm import moe_gmm as gk  # noqa: E402
from repro_torch.models import get_config  # noqa: E402
from repro_torch.models.common import reset_lengths, reset_recurrent  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402

torch.set_num_threads(1)
ROOT = pathlib.Path(__file__).resolve().parents[1]


def _functional_reset(cache, mask, state_keys=()):
    """The resets as they were before they wrote in place."""
    out = dict(cache)
    out["lengths"] = torch.where(mask, 0, cache["lengths"]).to(torch.int32)
    keep = ~mask
    for key in state_keys:
        leaf = cache[key]
        shape = [1] * leaf.dim()
        shape[1] = mask.shape[0]
        out[key] = leaf * keep.to(leaf.dtype).reshape(shape)
    return out


def _bits(t):
    """A tensor's bits, so -0.0 and 0.0 differ."""
    if t.is_floating_point():
        return t.view({2: torch.int16, 4: torch.int32}[t.element_size()])
    return t


@pytest.mark.parametrize("recurrent", [False, True])
def test_reset_in_place_equals_functional_bitwise(recurrent):
    """Each leaf keeps its address and takes bitwise the functional
    version's values (negative states give -0.0 there, kept by mul_)."""
    gen = torch.Generator().manual_seed(0)
    cache = {"lengths": torch.tensor([3, 9, 0, 5], dtype=torch.int32),
             "ssm": torch.randn(2, 4, 3, 5, generator=gen),
             "conv": torch.randn(2, 4, 3, 6, generator=gen)
             .to(torch.bfloat16),
             "kv": torch.randn(2, 7, 3, generator=gen)}
    mask = torch.tensor([True, False, True, False])
    keys = ("ssm", "conv") if recurrent else ()
    want = _functional_reset({k: v.clone() for k, v in cache.items()},
                             mask, keys)
    ptrs = {k: v.data_ptr() for k, v in cache.items()}
    out = (reset_recurrent(cache, mask) if recurrent
           else reset_lengths(cache, mask))
    assert out is cache
    assert {k: v.data_ptr() for k, v in cache.items()} == ptrs
    for key, leaf in want.items():
        assert torch.equal(_bits(cache[key]), _bits(leaf)), key


def test_reset_recurrent_checks_every_leaf_before_writing():
    """A leaf with its batch elsewhere raises before any leaf is written."""
    cache = {"lengths": torch.tensor([3, 4], dtype=torch.int32),
             "ssm": torch.ones(3, 2, 4), "conv": torch.ones(2, 5, 7)}
    with pytest.raises(ValueError, match="conv"):
        reset_recurrent(cache, torch.tensor([True, False]))
    assert cache["lengths"].tolist() == [3, 4]
    assert bool((cache["ssm"] == 1).all())


def _engine(arch, n_pages=None, **over):
    cfg = dataclasses.replace(
        get_config(arch, smoke=True), decode_kernel="pallas_paged",
        cache_layout="paged", kv_page_size=8, decode_splits=2, **over)
    params = convert.init(cfg, torch.Generator().manual_seed(0), "cpu")
    return ServeEngine(cfg, params, batch_slots=3, max_len=48, chunk_size=2,
                       n_pages=n_pages, device="cpu")


def _workload(vocab, n=6, seed=9):
    """Requests on one 17-token prefix (two full pages of 8) and on their
    own, of mixed budgets."""
    rng = np.random.default_rng(seed)
    common = rng.integers(0, vocab, 17).astype(np.int32)
    out = []
    for i in range(n):
        tail = rng.integers(0, vocab, int(rng.integers(2, 9))).astype(
            np.int32)
        prompt = np.concatenate([common, tail]) if i % 2 == 0 else tail
        out.append(Request(prompt=prompt, max_new_tokens=int(
            rng.integers(3, 9)), id=f"r{i}"))
    return out


# (arch, engine knobs): prefix attach and preemption on a short pool,
# forced preemptions, alloc refusals, the recurrent families (zamba2 over a
# paged pool under preemption; mamba2's contiguous fallback).
LIFECYCLE = {
    "preempt_shared": ("qwen2.5-32b", dict(prefix_sharing=True, n_pages=6)),
    "chaos_preempt": ("qwen2.5-32b", dict(prefix_sharing=True,
                                          chaos_preempt_p=0.5,
                                          chaos_seed=123)),
    "chaos_alloc_fail": ("qwen2.5-32b", dict(chaos_alloc_fail_p=0.4,
                                             chaos_seed=0, n_pages=8)),
    "zamba2_preempt": ("zamba2-2.7b", dict(preemption=True, n_pages=6)),
    "mamba2": ("mamba2-1.3b", dict(chaos_preempt_p=0.5, chaos_seed=3)),
    "olmoe": ("olmoe-1b-7b", dict(prefix_sharing=True, n_pages=6)),
    "spec_preempt_shared": ("qwen2.5-32b", dict(prefix_sharing=True,
                                                n_pages=6, spec_k=2)),
    "spec_zamba2_preempt": ("zamba2-2.7b", dict(preemption=True, n_pages=6,
                                                spec_k=3)),
    "spec_mamba2": ("mamba2-1.3b", dict(chaos_preempt_p=0.5, chaos_seed=3,
                                        spec_k=1)),
    "adaptive_warm": ("qwen2.5-32b", dict(prefix_sharing=True, n_pages=8,
                                          adaptive=True, warm_pages=3,
                                          adaptive_replan_every=1)),
}


@pytest.mark.parametrize("case", list(LIFECYCLE))
def test_no_static_buffer_rebound_through_the_lifecycle(case):
    """Admission waves, prefix attach, preemption and cancel write every
    static buffer in place: after each scheduler step every address equals
    the one recorded at construction (the guard also runs before every
    chunk), and the scenario fired."""
    arch, over = LIFECYCLE[case]
    eng = _engine(arch, **over)
    reqs = _workload(eng.cfg.vocab)
    eng.submit(reqs)
    steps = 0
    while True:
        more = eng.step()
        steps += 1
        assert eng._static_ptrs() == eng._static
        if steps == 3:
            eng.cancel(reqs[-1].id)
        if not more:
            break
    stats = eng.serve_stats()
    assert stats["chunks"] > 0 and stats["admission_waves"] > 1
    assert stats["cancelled"] == 1
    assert stats["graph_replays"] == 0           # no graph on the CPU
    fired = stats["preempted"] + stats["prefix_hits"] + getattr(
        getattr(eng, "allocator", None), "injected_failures", 0)
    assert fired > 0, f"{case}: the scenario did not fire"
    if eng.spec:
        assert stats["spec_rounds"] > 0
        assert {"hist", "hist_len", "spec_out"} <= {p[0] for p in eng._static}
    if eng.adaptive is not None:
        assert stats["warm_retained"] > 0


REBIND = {
    "lengths": lambda e: e.cache.__setitem__(
        "lengths", e.cache["lengths"].clone()),
    "pages": lambda e: e.cache.__setitem__("pages",
                                           e.cache["pages"].clone()),
    "ssm": lambda e: e.cache.__setitem__("ssm", e.cache["ssm"] * 1),
    "kv": lambda e: e.cache["kv"].__setitem__("k",
                                              e.cache["kv"]["k"].clone()),
    "cur_tok": lambda e: setattr(e, "cur_tok", e.cur_tok.clone()),
    "remaining": lambda e: setattr(e, "remaining", e.remaining.clone()),
    "out": lambda e: setattr(e, "_out", e._out.clone()),
    "param": lambda e: e.params["layers"][0]["ln"].__setitem__(
        "w", e.params["layers"][0]["ln"]["w"].clone()),
}


SPEC_REBIND = {
    "hist": lambda e: setattr(e, "hist", e.hist.clone()),
    "hist_len": lambda e: setattr(e, "hist_len", e.hist_len.clone()),
    "spec_out": lambda e: setattr(e, "_spec_out", e._spec_out.clone()),
    "scratch": lambda e: e._spec_scratch.__setitem__(
        "ssm", e._spec_scratch["ssm"].clone()),
}


@pytest.mark.parametrize("leaf", list(SPEC_REBIND))
def test_guard_raises_on_a_rebound_spec_buffer(leaf):
    """The speculative chunk's own buffers are under the same guard."""
    eng = _engine("zamba2-2.7b", spec_k=2)
    eng.submit(_workload(eng.cfg.vocab, n=3))
    eng.step()
    with torch.inference_mode():
        SPEC_REBIND[leaf](eng)
    with pytest.raises(RuntimeError, match="rebound"):
        eng.step()


@pytest.mark.parametrize("leaf", list(REBIND))
def test_guard_raises_on_a_rebound_buffer(leaf):
    """A buffer rebound on purpose between chunks makes the next chunk
    raise instead of running on (under a graph: replaying into) the old
    one."""
    eng = _engine("zamba2-2.7b")
    eng.submit(_workload(eng.cfg.vocab, n=3))
    eng.step()
    with torch.inference_mode():
        REBIND[leaf](eng)
    with pytest.raises(RuntimeError, match="rebound"):
        eng.step()


def test_guard_raises_on_a_moved_split_count():
    eng = _engine("qwen2.5-32b")
    eng.submit(_workload(eng.cfg.vocab, n=3))
    eng.step()
    eng.decode_splits += 1
    with pytest.raises(RuntimeError, match="recapture"):
        eng.step()


def test_cuda_graph_flag_is_inert_on_the_cpu():
    """On the CPU both settings run the same eager chunk: equal streams,
    no capture, one host sync per chunk and per wave."""
    runs = []
    for flag in (True, False):
        cfg = dataclasses.replace(get_config("qwen2.5-32b", smoke=True),
                                  decode_kernel="pallas_paged",
                                  cache_layout="paged", kv_page_size=8)
        params = convert.init(cfg, torch.Generator().manual_seed(0), "cpu")
        eng = ServeEngine(cfg, params, batch_slots=3, max_len=48,
                          chunk_size=3, device="cpu", cuda_graph=flag)
        assert eng.cuda_graph is False and eng._graph is None
        reqs = eng.run(_workload(cfg.vocab))
        stats = eng.serve_stats()
        assert stats["host_syncs"] == stats["chunks"] + stats[
            "admission_waves"]
        assert (stats["graph_replays"], stats["captured_launches"]) == (0, 0)
        runs.append([r.generated for r in reqs])
    assert runs[0] == runs[1]


def test_counters_delta_restore_advance():
    """The counter set a replay advances: a snapshot's delta, put back,
    then added once a replay, body counts included."""
    counters.snapshot()
    dk.reset_counters()
    gk.reset_counters()
    before = counters.snapshot()
    dk.paged_decode_attention.launches += 4
    gk.grouped_matmul.launches += 3
    gk.grouped_matmul.body_launches["decode"] += 3
    moved = counters.delta(counters.snapshot(), before)
    assert moved == {"paged_decode_attention.launches": 4,
                     "grouped_matmul.launches": 3,
                     "grouped_matmul.body_launches[decode]": 3}
    assert counters.launches(moved) == 7
    counters.restore(before)
    assert counters.snapshot() == before
    counters.advance(moved)
    counters.advance(moved)
    assert dk.paged_decode_attention.launches == 8
    assert gk.grouped_matmul.body_launches["decode"] == 6
    dk.reset_counters()
    gk.reset_counters()


def test_replay_symbols_cover_every_counter_and_kernel():
    """``chip_smoke.py`` holds a profiled replay's kernels to the captured
    counts through ``REPLAY_SYMBOLS``: every launch counter is mapped, and
    every ``__global__`` kernel of the CUDA sources matches exactly one
    wrapper's launch pattern (so no kernel is counted twice or missed)."""
    spec = importlib.util.spec_from_file_location("chip_smoke_symbols",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    mapped = [n for _, names in cs.REPLAY_SYMBOLS.values() for n in names]
    assert sorted(mapped) == sorted(
        n for n in counters.snapshot() if not n.endswith(".calls"))
    wrappers = [pattern for pattern, names in cs.REPLAY_SYMBOLS.values()
                if any(n.endswith((".launches", ".splitk_launches"))
                       for n in names)]
    kernels = [name for cu in sorted(
        (ROOT / "src/repro_torch/kernels").glob("*/csrc/*.cu"))
        for name in re.findall(
            r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)",
            cu.read_text())]
    assert len(kernels) >= 12
    for name in kernels:
        key = f"void (anonymous namespace)::{name}<float, 4>(Args)"
        assert sum(bool(re.search(p, key)) for p in wrappers) == 1, name


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: a CUDA graph has no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen2.5-32b", "zamba2-2.7b",
                                  "mamba2-1.3b", "olmoe-1b-7b"])
def test_graph_streams_equal_eager_on_the_card(card, arch):
    """The graphed chunk against the eager loop on the card (bf16 SMOKE):
    bitwise equal streams, one replay a chunk, and the launch counters
    equal to the eager run's."""
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="bfloat16",
                              decode_kernel="pallas_paged",
                              cache_layout="paged", kv_page_size=8)
    params = convert.init(cfg, torch.Generator("cuda").manual_seed(0),
                          "cuda")
    out = {}
    for flag in (True, False):
        eng = ServeEngine(cfg, params, batch_slots=3, max_len=48,
                          chunk_size=4, device="cuda", cuda_graph=flag)
        before = counters.snapshot()
        reqs = eng.run(_workload(cfg.vocab))
        stats = eng.serve_stats()
        out[flag] = ([r.generated for r in reqs],
                     counters.delta(counters.snapshot(), before))
        assert stats["graph_replays"] == (stats["chunks"] if flag else 0)
    assert out[True] == out[False]


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen2.5-32b", "zamba2-2.7b"])
def test_spec_graph_streams_equal_eager_on_the_card(card, arch):
    """The graphed speculative chunk (rewind: qwen; replay: zamba2)
    against its eager loop on the card: bitwise equal streams and
    speculative counters, one replay a chunk."""
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="bfloat16",
                              decode_kernel="pallas_paged",
                              cache_layout="paged", kv_page_size=8,
                              spec_k=3, spec_ngram=2)
    params = convert.init(cfg, torch.Generator("cuda").manual_seed(0),
                          "cuda")
    out = {}
    for flag in (True, False):
        eng = ServeEngine(cfg, params, batch_slots=3, max_len=48,
                          chunk_size=8, device="cuda", cuda_graph=flag)
        reqs = eng.run(_workload(cfg.vocab))
        stats = eng.serve_stats()
        out[flag] = ([r.generated for r in reqs],
                     [stats[k] for k in ("spec_rounds", "draft_proposed",
                                         "draft_accepted", "spec_tokens")])
        assert stats["graph_replays"] == (stats["chunks"] if flag else 0)
    assert out[True] == out[False]
