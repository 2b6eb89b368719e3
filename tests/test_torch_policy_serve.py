"""The port's ServeEngine planning from its cache-policy engine, held
against the JAX ServeEngine with both policy engines on the v5e model: the
decode kernels' split count baked from the decode plan (an explicit count
wins), the KV residency, the ``policy_report()`` sections the two engines
share, and greedy streams under the planned split count."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro.core import make_engine as r_make  # noqa: E402
from repro.core.planner import PlanCache as RPlanCache  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.models import get_config as jax_config  # noqa: E402
from repro.serve.engine import Request as JaxRequest  # noqa: E402
from repro.serve.engine import ServeEngine as JaxEngine  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import make_engine as t_make  # noqa: E402
from repro_torch.core.planner import PlanCache as TPlanCache  # noqa: E402
from repro_torch.models import get_config  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402

torch.set_num_threads(1)
ARCHS = ["qwen2.5-32b", "yi-9b", "zamba2-2.7b", "mamba2-1.3b", "olmoe-1b-7b"]
# The reference's report sections, every one of which the port now has.
SHARED = ("kv_bytes_per_layer", "kv_residency", "cache_layout", "sampling",
          "plan_cache", "speculative", "paged_kv", "prefix_sharing",
          "adaptive", "lifecycle", "integrity", "decode_attention")

_PARAMS = {}


def _params(arch):
    """(jax params, port params) of ``arch``'s SMOKE config, from one seed."""
    if arch not in _PARAMS:
        jp = jax_build(jax_config(arch, smoke=True)).init(
            jax.random.PRNGKey(0))
        _PARAMS[arch] = (jp, convert.from_jax(
            jp, get_config(arch, smoke=True), "cpu"))
    return _PARAMS[arch]


def _engines(arch, *, slots=2, max_len=32, n_pages=None, chunk_size=8,
             **cfg_kw):
    """The JAX and the port's engine on the same config, each with a fresh
    v5e policy engine (the default PlanCache is shared process-wide)."""
    jp, tp = _params(arch)
    jcfg = dataclasses.replace(jax_config(arch, smoke=True), **cfg_kw)
    tcfg = dataclasses.replace(get_config(arch, smoke=True), **cfg_kw)
    jeng = JaxEngine(jcfg, jp, batch_slots=slots, max_len=max_len,
                     n_pages=n_pages, chunk_size=chunk_size,
                     policy_engine=r_make(chip="tpu-v5e",
                                          plan_cache=RPlanCache()))
    teng = ServeEngine(tcfg, tp, batch_slots=slots, max_len=max_len,
                       n_pages=n_pages, chunk_size=chunk_size, device="cpu",
                       policy_engine=t_make(chip="tpu-v5e",
                                            plan_cache=TPlanCache()))
    return jeng, teng


def _shared(report):
    return {k: report[k] for k in SHARED if k in report}


@pytest.mark.parametrize("layout, max_len", [
    ("paged", 32), ("paged", 1024), ("paged", 2048), ("contiguous", 32),
    ("contiguous", 2048),
])
@pytest.mark.parametrize("arch", ARCHS)
def test_planned_decode_splits_equal_jax_engine(arch, layout, max_len):
    """The split count the engine bakes into ``cfg.decode_splits`` (route
    ``pallas_paged``), its KV residency and its decode plan equal the JAX
    engine's; the model is built with that count."""
    jeng, teng = _engines(arch, max_len=max_len, cache_layout=layout,
                          kv_page_size=16, decode_kernel="pallas_paged")
    assert teng.decode_splits == jeng.decode_splits
    assert teng.cfg.decode_splits == jeng.cfg.decode_splits
    assert teng.paged == jeng.paged
    assert teng.kv_residency.value == jeng.kv_residency.value
    assert (teng.decode_plan is None) == (jeng.decode_plan is None)
    assert _shared(teng.policy_report()) == _shared(jeng.policy_report())
    if teng.decode_plan is not None:
        assert teng.cfg.decode_splits >= 1
        assert teng.model.config.decode_splits == teng.decode_splits


@pytest.mark.parametrize("kernel", ["pallas_paged", "pallas_gather", "xla"])
def test_pinned_split_count_wins(kernel):
    jeng, teng = _engines("qwen2.5-32b", max_len=2048, cache_layout="paged",
                          kv_page_size=16, decode_kernel=kernel,
                          decode_splits=3)
    assert teng.decode_splits == jeng.decode_splits == 3
    assert teng.cfg.decode_splits == 3
    rep = teng.policy_report()["decode_attention"]
    assert rep["planned_splits"] == 3 and rep["kernel"] == kernel
    assert _shared(teng.policy_report()) == _shared(jeng.policy_report())


def test_xla_route_keeps_the_config_unplanned():
    """Under ``"xla"`` nothing is baked, as in the reference."""
    jeng, teng = _engines("qwen2.5-32b", max_len=2048, cache_layout="paged",
                          kv_page_size=16, decode_kernel="xla")
    assert teng.cfg.decode_splits == jeng.cfg.decode_splits == 0
    assert teng.decode_splits == jeng.decode_splits >= 1


def test_paged_policy_report_sees_pooled_bytes():
    """Residency planning sees the pool's real footprint, not the
    contiguous worst case, in both engines."""
    jcont, tcont = _engines("yi-9b", slots=4, max_len=32)
    jpool, tpool = _engines("yi-9b", slots=4, max_len=32, n_pages=8,
                            cache_layout="paged", kv_page_size=8)
    rc, rp = tcont.policy_report(), tpool.policy_report()
    assert rp["kv_bytes_per_layer"] * 2 == rc["kv_bytes_per_layer"]
    assert rp["paged_kv"]["pool_positions"] == 64
    assert rp["paged_kv"]["contiguous_positions"] == 128
    assert _shared(rc) == _shared(jcont.policy_report())
    assert _shared(rp) == _shared(jpool.policy_report())


def _requests(cls, vocab, n=6, seed=0):
    rng = np.random.default_rng(seed)
    return [cls(prompt=rng.integers(0, vocab, size=int(m)).astype(np.int32),
                max_new_tokens=int(k))
            for m, k in zip(rng.integers(3, 40, n), rng.integers(4, 12, n))]


@pytest.mark.parametrize("arch, kw", [
    ("qwen2.5-32b", dict(max_len=1024)),
    ("qwen2.5-32b", dict(max_len=64, n_pages=9, prefix_sharing=True)),
    ("zamba2-2.7b", dict(max_len=1024)),
])
def test_streams_and_report_equal_jax_engine_under_planned_splits(arch, kw):
    """Greedy streams under the planned split count (2 at 1024 positions:
    the plan's 512-token KV blocks) equal the JAX engine's, and after the
    run (waves re-planned through the PlanCache, prefix sharing and
    preemption on a small pool) the shared report sections are equal."""
    kw = dict(kw)
    sharing = kw.pop("prefix_sharing", False)
    jeng, teng = _engines(arch, slots=3, chunk_size=4, cache_layout="paged",
                          kv_page_size=16, decode_kernel="pallas_paged",
                          prefix_sharing=sharing, **kw)
    assert teng.decode_splits == jeng.decode_splits
    if kw["max_len"] == 1024:
        assert teng.decode_splits == 2
    vocab = get_config(arch, smoke=True).vocab
    jreqs = jeng.run(_requests(JaxRequest, vocab))
    treqs = teng.run(_requests(Request, vocab))
    assert [r.generated for r in treqs] == [r.generated for r in jreqs]
    tr, jr = teng.policy_report(), jeng.policy_report()
    assert tr["plan_cache"]["hits"] > 0 and teng.stats["admission_waves"] > 1
    assert _shared(tr) == _shared(jr)
    assert set(tr) == {k for k in SHARED if k in jr}


def test_default_policy_engine_models_the_h100():
    """Without a policy engine the port plans for the H100 (the reference
    defaults to the v5e): at 16 slots x 2048 positions over 16-token pages
    the decode plan's 512-token KV blocks give 4 splits."""
    _, tp = _params("qwen2.5-32b")
    cfg = dataclasses.replace(get_config("qwen2.5-32b", smoke=True),
                              cache_layout="paged", kv_page_size=16,
                              decode_kernel="pallas_paged")
    eng = ServeEngine(cfg, tp, batch_slots=16, max_len=2048, device="cpu")
    assert eng.policy.chip.name == "h100"
    assert eng.decode_plan.block["bkv"] == 512
    assert eng.decode_splits == eng.cfg.decode_splits == 4


@pytest.mark.parametrize("s, bkv", [(1024, 16), (1024, 512), (2048, 16),
                                    (48, 16), (513, 512)])
def test_decode_ops_plan_splits_from_the_engine(s, bkv):
    """``plan_splits(..., plan=)`` and the decode ops' ``engine=`` argument
    as the reference's: one split per planned KV block, the same count
    and values within the fp32 tolerance of the Pallas kernels."""
    import jax.numpy as jnp

    from repro.kernels.decode_attention import ops as rdec
    from repro_torch.kernels.decode_attention import ops as tdec

    b, hq, hkv, d = 2, 4, 2, 32
    reng = r_make(chip="tpu-v5e", plan_cache=RPlanCache())
    teng = t_make(chip="tpu-v5e", plan_cache=TPlanCache())
    rplan = rdec._engine_plan(reng, b, hq, hkv, s, d)
    tplan = tdec._engine_plan(teng, b, hq, hkv, s, d)
    assert tplan.block == rplan.block
    splits = tdec.plan_splits(s, bkv, plan=tplan)
    assert splits == rdec.plan_splits(s, bkv, plan=rplan)
    rng = np.random.default_rng(s + bkv)
    q = rng.standard_normal((b, hq, d)).astype(np.float32)
    k = rng.standard_normal((b, hkv, s, d)).astype(np.float32)
    v = rng.standard_normal((b, hkv, s, d)).astype(np.float32)
    lengths = np.array([s, s // 2 + 1], np.int32)
    want = np.asarray(rdec.decode_attention(
        *(jnp.asarray(x) for x in (q, k, v, lengths)), engine=reng,
        bkv=bkv, interpret=True))
    tq, tk, tv, tl = (torch.from_numpy(x) for x in (q, k, v, lengths))
    got = tdec.decode_attention(tq, tk, tv, tl, engine=teng, bkv=bkv)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-3, atol=2e-3)
    pinned = tdec.decode_attention(tq, tk, tv, tl, bkv=bkv, splits=splits)
    assert torch.equal(got, pinned)
    if s % 16 == 0:
        # The paged form over 16-token pages plans over the same width.
        pool_k = tk.transpose(1, 2).reshape(b * s // 16, 16, hkv, d)
        pool_v = tv.transpose(1, 2).reshape(b * s // 16, 16, hkv, d)
        pages = torch.arange(b * s // 16, dtype=torch.int32).reshape(b, -1)
        paged = tdec.paged_decode_attention(tq, pool_k, pool_v, pages, tl,
                                            engine=teng)
        np.testing.assert_allclose(paged.numpy(), want, rtol=2e-3,
                                   atol=2e-3)
