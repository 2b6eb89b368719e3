"""The port's cache-policy core (``repro_torch.core``, ``repro_torch.hw``)
held against the JAX package's (``repro.core``, ``repro.hw``): the same
arguments give plans and modeled costs equal with ``==`` under every
static mode and knob, the paper's 17 workloads cost and classify the same,
a predictor site table saved by one package loads in the other, and the
port's own additions (the H100 model, the explicit chip table, the dtype
names) behave as documented.  No hypothesis: every case is listed."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import hw as rhw  # noqa: E402
from repro.core import characterize as rchar  # noqa: E402
from repro.core import cost_model as rcost  # noqa: E402
from repro.core import policy as rpol  # noqa: E402
from repro.core import remat as rremat  # noqa: E402
from repro.core import sweep as rsweep  # noqa: E402
from repro.core.allocator import mxu_efficiency as r_mxu  # noqa: E402
from repro.core.engine import make_engine as r_make  # noqa: E402
from repro.core.planner import PlanCache as RPlanCache  # noqa: E402
from repro.core.predictor import PolicyPredictor as RPredictor  # noqa: E402
from repro.workloads.suite import SUITE  # noqa: E402
from repro_torch import hw as thw  # noqa: E402
from repro_torch.core import characterize as tchar  # noqa: E402
from repro_torch.core import cost_model as tcost  # noqa: E402
from repro_torch.core import policy as tpol  # noqa: E402
from repro_torch.core import remat as tremat  # noqa: E402
from repro_torch.core import sweep as tsweep  # noqa: E402
from repro_torch.core.allocator import mxu_efficiency as t_mxu  # noqa: E402
from repro_torch.core.engine import EngineConfig, chip_by_name  # noqa: E402
from repro_torch.core.engine import make_engine as t_make  # noqa: E402
from repro_torch.core.planner import PlanCache as TPlanCache  # noqa: E402
from repro_torch.core.predictor import PolicyPredictor as TPredictor  # noqa: E402
from repro_torch.device import dtype_name  # noqa: E402

CHIPS = {"tpu-v5e": (rhw.V5E, thw.V5E), "gem5-apu": (rhw.PAPER_GPU,
                                                     thw.PAPER_GPU)}
MODES = ["uncached", "cacher", "cacherw", "adaptive"]

# (constructor, args, kwargs): ragged and tiny shapes, split_k, causal and
# decode-shaped attention, GQA, every dtype the planner sizes.
OPS = [
    ("matmul_op", (4096, 4096, 4096), {}),
    ("matmul_op", (4096, 4096, 4096), {"dtype": "bfloat16"}),
    ("matmul_op", (130, 70, 90), {"dtype": "float32"}),
    ("matmul_op", (1, 1, 1), {}),
    ("matmul_op", (16, 4096, 65536), {"dtype": "bfloat16"}),
    ("matmul_op", (200, 300, 100), {"dtype": "float32"}),
    ("matmul_op", (64, 8192, 64), {"split_k": 4}),
    ("matmul_op", (1024, 11008, 4096), {"dtype": "bfloat16",
                                        "out_dtype": "float32"}),
    ("matmul_op", (333, 777, 555), {"bm": 128, "bn": 64, "bk": 256}),
    ("attention_op", (2, 8, 2, 1024, 1024, 64), {}),
    ("attention_op", (1, 16, 16, 512, 512, 128), {"causal": False}),
    ("attention_op", (16, 32, 4, 1, 2048, 128), {"causal": False,
                                                 "name": "serve_decode"}),
    ("attention_op", (4, 8, 1, 37, 1000, 80), {"dtype": "float32"}),
    ("elementwise_op", (1 << 20,), {}),
    ("elementwise_op", (12345,), {"n_inputs": 3, "n_outputs": 2,
                                  "flops_per_elem": 4.0}),
    ("rowwise_op", (4096, 4096), {}),
    ("rowwise_op", (7, 33), {"passes": 2, "dtype": "float32"}),
    ("window_op", (1 << 22, 9, 1, 3), {}),
    ("window_op", (1 << 22, 5, 1, 1 << 20), {"name": "lrn"}),
    ("conv2d_op", (32, 64, 56, 56, 64, 3, 3), {}),
    ("conv2d_op", (8, 3, 224, 224, 64, 7, 7), {"stride": 2}),
]


def _ops(mod):
    return [getattr(mod, fn)(*args, **kw) for fn, args, kw in OPS]


def _plan_fields(plan):
    return dict(
        assignment={k: v.value for k, v in plan.assignment.items()},
        block=dict(plan.block), grid_order=tuple(plan.grid_order),
        vmem_bytes=plan.vmem_bytes, demotions=tuple(plan.demotions),
        shrink_events=plan.shrink_events, rinse=plan.rinse, notes=plan.notes)


def _bd(bd):
    return dataclasses.asdict(bd)


def _to_port(op):
    """A reference OpSpec converted field by field into the port's."""
    operands = tuple(
        tpol.OperandProfile(**{f.name: getattr(o, f.name)
                               for f in dataclasses.fields(o)})
        for o in op.operands)
    return tpol.OpSpec(kind=op.kind, operands=operands, flops=op.flops,
                       dtype=op.dtype, meta=dict(op.meta), name=op.name)


def _assign(a):
    return {k: v.value for k, v in a.items()}


@pytest.mark.parametrize("rinse", [True, False])
@pytest.mark.parametrize("bypass", [True, False])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("chip", sorted(CHIPS))
def test_plans_and_costs_equal_the_reference(chip, mode, bypass, rinse):
    """Every op of the grid under every mode and knob: the KernelPlan's
    fields, the engine's cost breakdown and the MXU efficiency equal the
    reference's with ``==``; so do the plan-cache counters after a repeat
    (every repeat a hit)."""
    # Fresh caches: the default PlanCache is shared by the whole process.
    reng = r_make(mode, allocation_bypass=bypass, rinse=rinse, chip=chip,
                  plan_cache=RPlanCache())
    teng = t_make(mode, allocation_bypass=bypass, rinse=rinse, chip=chip,
                  plan_cache=TPlanCache())
    for _ in range(2):
        for rop, top in zip(_ops(rchar), _ops(tchar)):
            rp, tp = reng.plan_op(rop), teng.plan_op(top)
            assert _plan_fields(tp) == _plan_fields(rp), rop.name
            assert _bd(teng.cost(top, tp)) == _bd(reng.cost(rop, rp))
            assert t_mxu(tp, teng.chip) == r_mxu(rp, reng.chip)
    assert teng.plan_stats() == reng.plan_stats()
    assert teng.plan_stats()["hits"] > 0


@pytest.mark.parametrize("chip", sorted(CHIPS))
def test_op_specs_characterize_alike(chip):
    """Op constructors, static assignments, the op table, the vectorized
    sweep (every lattice array), the exact argmin and workload classes."""
    rchip, tchip = CHIPS[chip]
    rops, tops = _ops(rchar), _ops(tchar)
    for rop, top in zip(rops, tops):
        assert _to_port(rop) == top
        for mode in ("uncached", "cacher", "cacherw"):
            assert _assign(tpol.static_assignment(
                top, tpol.StaticMode(mode))) == _assign(
                rpol.static_assignment(rop, rpol.StaticMode(mode)))
        for ab in (True, False):
            for rn in (True, False):
                assert _assign(tsweep.optimal_assignment(
                    top, chip=tchip, allocation_bypass=ab, rinse=rn)
                ) == _assign(rsweep.optimal_assignment(
                    rop, chip=rchip, allocation_bypass=ab, rinse=rn))
        assert _assign(tcost.adaptive_assignment(top, tchip)) == _assign(
            rcost.adaptive_assignment(rop, rchip))
    assert tchar.op_table(tops) == rchar.op_table(rops)
    rbs, tbs = rsweep.sweep_ops(rops, chip=rchip), tsweep.sweep_ops(
        tops, chip=tchip)
    for name in ("t_compute", "t_hbm", "t_overhead0", "t_total0",
                 "read_bytes", "write_bytes", "contiguity", "stall",
                 "demotions", "vmem", "valid"):
        np.testing.assert_array_equal(getattr(tbs, name), getattr(rbs, name))
    for i in range(len(rops)):
        got, t = tbs.best(i)
        want, r = rbs.best(i)
        assert (_assign(got), t) == (_assign(want), r)
    for group in (rops[:9], rops[9:13], rops[13:]):
        tgroup = [_to_port(op) for op in group]
        assert tchar.classify_workload(tgroup, chip=tchip).value == \
            rchar.classify_workload(group, chip=rchip).value


@pytest.mark.parametrize("name", sorted(SUITE))
def test_suite_workloads_cost_classify_and_adapt_alike(name):
    """The paper's 17 workloads (``repro.workloads.suite``), converted op by
    op: equal ``workload_cost`` under every mode on both chip models, equal
    classes, and the adaptive stack within 5 % of the best static policy,
    the check ``examples/policy_explorer.py`` prints (17/17 over the
    parametrisation)."""
    rops = SUITE[name].ops
    tops = [_to_port(op) for op in rops]
    for chip in sorted(CHIPS):
        rchip, tchip = CHIPS[chip]
        t = {}
        for mode in rpol.StaticMode:
            want = rcost.workload_cost(rops, mode=mode, chip=rchip,
                                       launches_per_op=1)
            got = tcost.workload_cost(tops, mode=tpol.StaticMode(mode.value),
                                      chip=tchip, launches_per_op=1)
            assert _bd(got) == _bd(want), (chip, mode)
            t[mode.value] = got.t_total
        assert tchar.classify_workload(tops, chip=tchip).value == \
            rchar.classify_workload(rops, chip=rchip).value
        if chip == "gem5-apu":
            best = min(t["uncached"], t["cacher"], t["cacherw"])
            assert t["adaptive"] <= best * 1.05


def test_sweep_table_and_serve_argmin_equal_the_reference():
    rops = [op for w in SUITE.values() for op in w.ops][:40]
    tops = [_to_port(op) for op in rops]
    rtab, ttab = rsweep.SweepTable(rhw.V5E), tsweep.SweepTable(thw.V5E)
    rtab.add(rops)
    ttab.add(tops)
    for mode in rpol.StaticMode:
        assert _bd(ttab.workload_cost(tops, mode=tpol.StaticMode(mode.value))
                   ) == _bd(rtab.workload_cost(rops, mode=mode))
    assert ttab.stats() == rtab.stats()
    assert tsweep.SERVE_COMBOS == rsweep.SERVE_COMBOS
    for feats in ({}, {"prompt_mean": 300.0, "shared_tokens": 256.0,
                       "hit_rate": 0.8, "warm_budget": 64, "page_size": 16},
                  {"prompt_mean": 100.0, "shared_tokens": 64.0,
                   "hit_rate": 0.1, "churn": 0.9, "reuse_signal": 1.0,
                   "warm_budget": 32, "page_size": 16, "spec_k": 4,
                   "spec_acceptance": 0.5}):
        assert tsweep.serve_policy_argmin(feats) == \
            rsweep.serve_policy_argmin(feats)


@pytest.mark.parametrize("chip", sorted(CHIPS))
def test_kv_policy_and_remat_equal_the_reference(chip):
    reng, teng = r_make(chip=chip), t_make(chip=chip)
    for kv in (0, 1 << 10, 1 << 20, 1 << 24, 24 << 20, 1 << 27, 67 << 20):
        assert teng.kv_policy(kv).value == reng.kv_policy(kv).value
    for act in (1e6, 5e8, 2e9, 8e9):
        for layers in (4, 48):
            assert teng.remat_policy(act, layers).value == \
                reng.remat_policy(act, layers).value
            assert tremat.choose_policy(act, layers, 16e9).value == \
                rremat.choose_policy(act, layers, 16e9).value
    for pol in tremat.RematPolicy:
        assert tremat.extra_flops_factor(pol) == rremat.extra_flops_factor(
            rremat.RematPolicy(pol.value))


@pytest.mark.parametrize("direction", ["reference_to_port", "port_to_reference"])
def test_predictor_site_table_crosses_packages(tmp_path, direction):
    """A site table trained by feedback in one package, saved as JSON,
    loads in the other: same table, same predictions."""
    rops, tops = _ops(rchar), _ops(tchar)
    src_ops = rops if direction == "reference_to_port" else tops
    dst_ops = tops if direction == "reference_to_port" else rops
    src, dst = ((RPredictor(rhw.V5E), TPredictor(thw.V5E))
                if direction == "reference_to_port"
                else (TPredictor(thw.V5E), RPredictor(rhw.V5E)))
    for i, op in enumerate(src_ops):
        a = src.predict(op)
        for benefit in (-1.0, -1.0, -1.0) if i % 3 == 0 else (0.5,):
            src.update(op, a, benefit)
    path = str(tmp_path / "sites.json")
    src.save(path)
    dst.load(path)
    assert len(dst) == len(src)
    assert {k.encode(): dataclasses.asdict(v) for k, v in dst.table.items()} \
        == {k.encode(): dataclasses.asdict(v) for k, v in src.table.items()}
    for sop, dop in zip(src_ops, dst_ops):
        assert _assign(dst.predict(dop)) == _assign(src.predict(sop))
    assert any(e.policy == "stream" and e.updates for e in dst.table.values())


def test_engine_feedback_equal_the_reference():
    reng, teng = r_make(chip="tpu-v5e"), t_make(chip="tpu-v5e")
    for rop, top in zip(_ops(rchar), _ops(tchar)):
        rp, tp = reng.plan_op(rop), teng.plan_op(top)
        t = reng.cost(rop, rp).t_total
        for measured in (t * 0.5, t * 4.0):
            reng.feedback(rop, rp, measured)
            teng.feedback(top, tp, measured)
    assert {k.encode(): dataclasses.asdict(v)
            for k, v in teng.predictor.table.items()} == \
        {k.encode(): dataclasses.asdict(v)
         for k, v in reng.predictor.table.items()}


def test_h100_model_plans_the_serve_shapes():
    """The H100 model: the data sheet's rates, the 50 MB L2 as the
    residency capacity; yi-9b's decode step at 16 x 2048 plans 512-token KV
    blocks, so 4 splits over 16-token pages; its layer GEMMs keep
    512-wide windows inside the L2 budget."""
    from repro_torch.kernels.decode_attention.ops import plan_splits

    h = thw.H100
    assert (h.peak_flops_bf16, h.peak_flops_fp32, h.hbm_bw) == (
        989e12, 67e12, 3.35e12)
    assert (h.vmem_bytes, h.hbm_burst_bytes, h.mxu_dim) == (
        50 * 1024 * 1024, 128, 64)
    assert h.ici_links * h.ici_bw_per_link == 450e9
    eng = t_make(chip="h100")
    assert eng.chip is h and EngineConfig().chip is h
    plan = eng.plan_op(tchar.attention_op(16, 32, 4, 1, 2048, 128,
                                          causal=False, name="serve_decode"))
    assert plan.block["bkv"] == 512
    assert plan_splits(2048, 16, plan=plan) == 4
    assert plan_splits(2048, 16) == 8          # the reference's default
    # yi-9b's 48-layer pool at 16 x 2048 streams; a small one is resident.
    assert eng.kv_policy(2 * 16 * 2048 * 4 * 128 * 2) is tpol.Policy.STREAM
    assert eng.kv_policy(1 << 20) is tpol.Policy.RESIDENT
    for m, k, n in [(16384, 4096, 4096), (16384, 4096, 11008),
                    (16384, 11008, 4096), (16, 4096, 65536)]:
        for mode in MODES:
            for rinse in (True, False):
                p = t_make(mode, rinse=rinse, chip="h100").plan_op(
                    tchar.matmul_op(m, k, n, dtype="bfloat16"))
                assert p.vmem_bytes <= h.vmem_budget
                assert p.block["bn"] == 512 and p.block["bk"] == 512
                assert p.block["bm"] == min(m, 512)


@pytest.mark.parametrize("name", ["a100", "tpu-v4", "H100", ""])
def test_unknown_chip_name_raises(name):
    """The reference maps every name but "gem5-apu" to v5e; the port's
    table raises instead."""
    with pytest.raises(ValueError, match="unknown chip"):
        t_make(chip=name)
    with pytest.raises(ValueError, match="unknown chip"):
        chip_by_name(name)
    assert r_make(chip=name).chip is rhw.V5E


def test_planner_takes_the_reference_dtype_names():
    """torch dtypes plan under the names the JAX package gives them:
    ``str(torch.bfloat16)`` is not a name ``hw.dtype_bytes`` knows."""
    assert dtype_name(torch.bfloat16) == "bfloat16"
    assert dtype_name(torch.float32) == "float32"
    with pytest.raises(ValueError, match="no planner name"):
        dtype_name(torch.int8)
    with pytest.raises(TypeError):
        thw.dtype_bytes(str(torch.bfloat16))
    reng = r_make(chip="tpu-v5e", plan_cache=RPlanCache())
    teng = t_make(chip="tpu-v5e", plan_cache=TPlanCache())
    # The names the reference's ops.matmul plans with: str(jax dtype).
    for dt, name in ((torch.bfloat16, "bfloat16"), (torch.float32, "float32")):
        rop = rchar.matmul_op(512, 384, 128, dtype=name)
        top = tchar.matmul_op(512, 384, 128, dtype=dtype_name(dt))
        assert _plan_fields(teng.plan_op(top)) == _plan_fields(
            reng.plan_op(rop))
    assert teng.plan_stats() == reng.plan_stats()
