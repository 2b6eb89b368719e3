"""The port's ServeEngine held against the JAX ServeEngine (greedy streams
equal), its own scheduling invariances, its refusals, and the rule that
the port imports nothing of JAX or the JAX package."""
import ast
import dataclasses
import pathlib

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
from repro_torch.serve.engine import AdmissionReject, Request, ServeEngine  # noqa: E402

torch.set_num_threads(1)
ROOT = pathlib.Path(__file__).resolve().parents[1]
PAGED = dict(cache_layout="paged", kv_page_size=16, decode_splits=2)


def _requests(cls, n_tokens=12):
    """examples/serve_decode.py's request set."""
    rng = np.random.default_rng(0)
    return [cls(prompt=rng.integers(0, 256, size=n).astype(np.int32),
                max_new_tokens=n_tokens) for n in (5, 8, 3, 6, 9, 4)]


@pytest.fixture(scope="module")
def jax_params():
    return jax_build(jax_config("qwen2.5-32b", smoke=True)).init(
        jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def params(jax_params):
    return convert.from_jax(jax_params, get_config("qwen2.5-32b", smoke=True),
                            "cpu")


def _port(kernel="pallas_paged", **kw):
    return dataclasses.replace(get_config("qwen2.5-32b", smoke=True),
                               decode_kernel=kernel, **{**PAGED, **kw})


def _serve(cfg, params, chunk_size=8, n_pages=None):
    eng = ServeEngine(cfg, params, batch_slots=4, max_len=64,
                      chunk_size=chunk_size, n_pages=n_pages, device="cpu")
    reqs = eng.run(_requests(Request))
    return [r.generated for r in reqs], eng


@pytest.mark.parametrize("kernel", ["pallas_paged", "xla"])
def test_streams_equal_jax_engine(jax_params, params, kernel):
    jcfg = dataclasses.replace(jax_config("qwen2.5-32b", smoke=True),
                               decode_kernel=kernel, **PAGED)
    want = JaxEngine(jcfg, jax_params, batch_slots=4, max_len=64,
                     chunk_size=8).run(_requests(JaxRequest))
    got, eng = _serve(_port(kernel), params)
    assert got == [r.generated for r in want]
    stats = eng.serve_stats()
    assert stats["chunks"] == stats["host_syncs"] - stats["admission_waves"]
    assert stats["decode_tokens"] + stats["prefill_tokens"] == 72


def test_streams_invariant_to_chunk_size_and_kernel(params):
    base, _ = _serve(_port(), params)
    assert _serve(_port(), params, chunk_size=3)[0] == base
    assert _serve(_port("pallas_gather"), params)[0] == base


def test_planned_splits_paged_equals_gather(params):
    """With decode_splits 0 the engine plans the split count from its
    policy engine, the same for the paged and the gather route, so their
    streams are equal."""
    paged, _ = _serve(_port(decode_splits=0), params)
    assert _serve(_port("pallas_gather", decode_splits=0), params)[0] == paged


def test_small_pool_gates_admission_without_changing_streams(params):
    """With preemption off, a short pool makes the head wait (PR 11's
    head-of-line gate); the streams do not change."""
    full, full_eng = _serve(_port(preemption=False), params)
    small, eng = _serve(_port(preemption=False), params, n_pages=3)
    assert small == full
    assert eng.stats["peak_pages_held"] <= 3 < full_eng.stats["peak_pages_held"]
    assert eng.stats["admission_waves"] > full_eng.stats["admission_waves"]
    assert sorted(eng.allocator.free_pages) == list(range(3))


def test_contiguous_cache_matches_paged(params):
    paged, _ = _serve(_port(), params)
    ring, _ = _serve(_port(cache_layout="contiguous"), params)
    assert ring == paged


@pytest.mark.parametrize("prompt_len, budget, reason", [
    (0, 4, "empty_prompt"), (5, 0, "zero_budget"), (60, 8, "max_len"),
])
def test_submit_rejects(params, prompt_len, budget, reason):
    eng = ServeEngine(_port(), params, batch_slots=2, max_len=64,
                      device="cpu")
    good = Request(prompt=np.ones(3, np.int32), max_new_tokens=2)
    bad = Request(prompt=np.ones(prompt_len, np.int32), max_new_tokens=budget)
    with pytest.raises(AdmissionReject) as e:
        eng.submit([good, bad])
    assert e.value.reason == reason and not eng.queue


def test_submit_rejects_over_pool_request(params):
    eng = ServeEngine(_port(), params, batch_slots=2, max_len=64, n_pages=2,
                      device="cpu")
    with pytest.raises(AdmissionReject) as e:
        eng.submit([Request(prompt=np.ones(30, np.int32), max_new_tokens=8)])
    assert e.value.reason == "pool_too_small"


def test_no_device_without_cuda_raises(params):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeEngine(_port(), params, batch_slots=2, max_len=64)


@pytest.mark.parametrize("change", [
    dict(chaos_corrupt_p=0.1), dict(spec_k=2),
    dict(chaos_crash_after_wave=1), dict(kv_integrity=True),
    dict(adaptive=True), dict(sampling="top_p"),
])
def test_unported_config_raises(params, change):
    with pytest.raises(NotImplementedError):
        ServeEngine(_port(**change), params, batch_slots=2, max_len=64,
                    device="cpu")


def test_journal_raises(params):
    with pytest.raises(NotImplementedError, match="journal_path"):
        ServeEngine(_port(), params, batch_slots=2, max_len=64,
                    journal_path="requests.jsonl", device="cpu")


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_no_jax_and_no_reference_package():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    bad = [(str(f.relative_to(ROOT)), name) for f in files
           for name in _imports(f)
           if name.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert bad == []
