"""The port's policy-planned matmul (plain version and the public op on CPU
tensors) held against the JAX package's Pallas kernel (interpret mode) and
its ``ref.py`` oracle: the reference's cases (accumulating and split-K),
both grid orders, and engine-planned calls whose plans and resolved
schedules equal the reference's under STREAM output (split-K),
RESIDENT_ACCUM output (``cacherw``) and ``rinse=False`` (the column-major
order); the CPU dispatch rule, the CUDA entry's input guards and the
wrapper's choice of body and launch by shape.  The kernel itself runs only
on the card (the ``cuda`` marker) and in ``chip_smoke.py``."""
import importlib.util
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.core import make_engine as r_make  # noqa: E402
from repro.kernels.common import cdiv as r_cdiv  # noqa: E402
from repro.kernels.matmul import ops as rops  # noqa: E402
from repro.kernels.matmul import ref as rref  # noqa: E402
from repro.kernels.matmul.matmul import matmul as rkern  # noqa: E402
from repro_torch.core import make_engine as t_make  # noqa: E402
from repro_torch.kernels.matmul import matmul as mk  # noqa: E402
from repro_torch.kernels.matmul import ops, ref  # noqa: E402

torch.set_num_threads(1)
# The reference's tolerances (tests/test_kernels.py TOL).
TOL = {"float32": dict(rtol=2e-3, atol=2e-3),
       "bfloat16": dict(rtol=3e-2, atol=3e-2)}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# The reference's cases (tests/test_kernels.py TestMatmul).
MKN = [(256, 128, 256), (512, 384, 128), (130, 70, 90)]
KWARGS = [dict(bm=128, bn=128, bk=128),
          dict(bm=128, bn=128, bk=128, split_k=3)]


def _inputs(seed, m, k, n, dtype):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = rng.standard_normal((k, n)).astype(np.float32)
    ja, jb = (jnp.asarray(x).astype(JDT[dtype]) for x in (a, b))
    ta, tb = (torch.from_numpy(x).to(TDT[dtype]) for x in (a, b))
    return (ja, jb), (ta, tb)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("kwargs", KWARGS)
@pytest.mark.parametrize("mkn", MKN)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_pallas_kernel_and_oracle(dtype, mkn, kwargs):
    (ja, jb), (ta, tb) = _inputs(0, *mkn, dtype)
    want_k = _np(rops.matmul(ja, jb, **kwargs, interpret=True))
    want_r = _np(rref.matmul(ja, jb))
    mk.reset_counters()
    got = ops.matmul(ta, tb, **kwargs)
    assert got.dtype == TDT[dtype] and tuple(got.shape) == (mkn[0], mkn[2])
    assert mk.matmul_plain.calls == 1 and mk.matmul.launches == 0
    assert mk.matmul.splitk_launches == 0
    for want in (want_k, want_r):
        np.testing.assert_allclose(_np(got), want, **TOL[dtype])
    np.testing.assert_allclose(_np(ref.matmul(ta, tb)), want_r, **TOL[dtype])


@pytest.mark.parametrize("split_k", [1, 3])
def test_grid_orders_match(split_k):
    """``mnk`` and ``nmk`` agree with each other and with the Pallas
    kernel's two orders (the split path ignores the order)."""
    (ja, jb), (ta, tb) = _inputs(1, 256, 256, 256, "float32")
    y1 = mk.matmul(ta, tb, bm=128, bn=128, bk=128, order="mnk",
                   split_k=split_k)
    y2 = mk.matmul(ta, tb, bm=128, bn=128, bk=128, order="nmk",
                   split_k=split_k)
    np.testing.assert_array_equal(_np(y1), _np(y2))
    for order in ("mnk", "nmk"):
        want = _np(rkern(ja, jb, bm=128, bn=128, bk=128, order=order,
                         split_k=split_k, interpret=True))
        np.testing.assert_allclose(_np(y1), want, **TOL["float32"])


@pytest.mark.parametrize("k, bk, split_k", [
    (384, 128, 3), (384, 128, 2), (70, 70, 3), (2048, 512, 2),
    (11008, 512, 5), (1000, 128, 7), (129, 128, 2), (4096, 512, 16),
])
def test_split_ranges_follow_the_reference_rule(k, bk, split_k):
    """ks and the split count as ``matmul.py`` computes them on K padded
    to a multiple of bk; the ranges cover [0, k), none empty."""
    kp = r_cdiv(k, bk) * bk
    ks_ref = r_cdiv(kp, split_k * bk) * bk
    ks, splits = mk.split_ranges(k, bk, split_k)
    assert (ks, splits) == (ks_ref, r_cdiv(kp, ks_ref))
    starts = [s * ks for s in range(splits)]
    assert all(start < k for start in starts) and splits * ks >= k
    assert ks % bk == 0


@pytest.mark.parametrize("split_k", [2, 3, 5])
def test_split_plain_sums_the_partials(split_k):
    """The plain split-K path sums fp32 partials over the split ranges: it
    equals the per-range products summed, and the full product closely."""
    _, (ta, tb) = _inputs(2, 64, 1000, 48, "float32")
    ks, splits = mk.split_ranges(1000, 128, split_k)
    want = sum(ta[:, s * ks:(s + 1) * ks] @ tb[s * ks:(s + 1) * ks]
               for s in range(splits))
    got = mk.matmul_plain(ta, tb, bk=128, split_k=split_k)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(_np(got), _np(ta @ tb), rtol=1e-5, atol=1e-4)


def _spy_reference_schedule(monkeypatch):
    """Record the schedule the reference's ops.matmul hands its kernel."""
    seen = {}
    real = rops._matmul_kernel

    def spy(a, b, **kw):
        seen.update({k: kw[k] for k in ("bm", "bn", "bk", "order",
                                        "split_k")})
        return real(a, b, **kw)

    monkeypatch.setattr(rops, "_matmul_kernel", spy)
    return seen


@pytest.mark.parametrize("mode, rinse, out_policy, order, split", [
    ("adaptive", True, "stream", "nmk", True),
    ("uncached", True, "stream", "nmk", True),
    ("cacherw", True, "resident_accum", "mnk", False),
    ("cacherw", False, "resident_accum", "nmk", False),
])
@pytest.mark.parametrize("mkn", [(256, 128, 256), (130, 70, 90),
                                 (512, 2048, 256)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_engine_planned_matches_reference(monkeypatch, dtype, mkn, mode,
                                          rinse, out_policy, order, split):
    """Both packages' engines (the v5e model) give equal plans, the same
    resolved (bm, bn, bk, order, split_k), and values within tolerance of
    the Pallas kernel and the oracle."""
    (ja, jb), (ta, tb) = _inputs(3, *mkn, dtype)
    reng = r_make(mode, rinse=rinse, chip="tpu-v5e")
    teng = t_make(mode, rinse=rinse, chip="tpu-v5e")
    seen = _spy_reference_schedule(monkeypatch)
    want = _np(rops.matmul(ja, jb, engine=reng, interpret=True))
    plan, schedule = ops.resolve_schedule(*mkn, dtype, engine=teng)
    assert schedule == seen
    assert plan.policy("out").value == out_policy
    assert schedule["order"] == order and (schedule["split_k"] > 1) == split
    rplan = reng.plan_op(rops.matmul_op(*mkn, dtype=str(ja.dtype)))
    assert (plan.block, plan.grid_order, plan.vmem_bytes) == (
        rplan.block, rplan.grid_order, rplan.vmem_bytes)
    assert {k: v.value for k, v in plan.assignment.items()} == {
        k: v.value for k, v in rplan.assignment.items()}
    mk.reset_counters()
    got = ops.matmul(ta, tb, engine=teng)
    assert mk.matmul_plain.calls == 1 and mk.matmul.launches == 0
    np.testing.assert_allclose(_np(got), want, **TOL[dtype])
    np.testing.assert_allclose(_np(got), _np(rref.matmul(ja, jb)),
                               **TOL[dtype])


def test_engine_planned_ones():
    """The reference's engine-planned case: all-ones, 300 deep."""
    a, b = torch.ones((200, 300)), torch.ones((300, 100))
    y = ops.matmul(a, b, engine=t_make(chip="tpu-v5e"))
    np.testing.assert_allclose(_np(y), 300.0, rtol=1e-5)
    y = ops.matmul(a, b, engine=t_make())            # the H100 model
    np.testing.assert_allclose(_np(y), 300.0, rtol=1e-5)


def test_explicit_kwargs_override_the_plan():
    _, (ta, tb) = _inputs(4, 96, 160, 64, "float32")
    teng = t_make("cacherw", chip="tpu-v5e")
    _, schedule = ops.resolve_schedule(96, 160, 64, "float32", engine=teng,
                                       bm=32, bk=64, split_k=4)
    assert schedule == dict(bm=32, bn=64, bk=64, order="mnk", split_k=4)
    _, schedule = ops.resolve_schedule(96, 160, 64, "float32")
    assert schedule == dict(bm=96, bn=64, bk=160, order="mnk", split_k=1)
    got = ops.matmul(ta, tb, engine=teng, bm=32, bk=64, split_k=4,
                     out_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(ta @ tb), **TOL["bfloat16"])


def _guard_args():
    return dict(a=torch.zeros(8, 16), b=torch.zeros(16, 4), out_dtype=None)


@pytest.mark.parametrize("change, message", [
    (dict(a=lambda g: g["a"][0]), r"a \(m, k\) and b \(k, n\)"),
    (dict(b=lambda g: torch.zeros(15, 4)), r"a \(m, k\) and b \(k, n\)"),
    (dict(a=lambda g: torch.zeros(0, 16)), "out of the kernel's range"),
    (dict(b=lambda g: g["b"].to(torch.bfloat16)), "share a dtype"),
    (dict(a=lambda g: g["a"].half(), b=lambda g: g["b"].half()),
     "share a dtype"),
    (dict(out_dtype=lambda g: torch.float16), "out_dtype"),
    (dict(a=lambda g: torch.zeros(16, 8).t()), "contiguous"),
    (dict(order=lambda g: "kmn"), "order must be"),
    (dict(bk=lambda g: 0), "at least 1"),
    (dict(split_k=lambda g: 0), "at least 1"),
    ({}, "CUDA tensors only"),
])
def test_cuda_entry_refuses_what_the_kernel_does_not_take(change, message):
    """The CUDA-only entry raises, naming the problem; it never falls back
    to the plain version (CPU tensors are refused too)."""
    args = _guard_args()
    for key, fn in change.items():
        args[key] = fn(args)
    mk.reset_counters()
    with pytest.raises(ValueError, match=message):
        mk.matmul_cuda(args.pop("a"), args.pop("b"), **args)
    assert mk.matmul_plain.calls == 0
    assert mk.matmul.launches == 0 and mk.matmul.splitk_launches == 0


def _chip_smoke():
    """``chip_smoke.py`` as a module (its shapes; nothing runs)."""
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_shapes", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _launch(m, k, n, dtype, *, lda=None, ldb=None, aligned=True, bk=512,
            split_k=1, sms=132):
    ks, splits = (mk.split_ranges(k, min(bk, k), split_k) if split_k > 1
                  else (k, 1))
    return mk.plan_launch(m, k, n, dtype, lda=lda or k, ldb=ldb or n,
                          aligned=aligned, ks=ks, splits=splits,
                          sms=sms), ks, splits


def test_launch_choice_at_every_planned_shape():
    """Every shape and mode x rinse plan of ``chip_smoke.py``'s
    ``policy_matmul`` phase: prefill takes the persistent ``wgmma`` body,
    one CTA an SM; every decode shape and the LM head (m 16) the
    ``small_m`` body with at least 132 CTAs streaming b, its cluster's K
    slices whole 64-deep stages that cover each split; fp32 the CUDA
    cores."""
    cs = _chip_smoke()
    engines = [t_make(mode, rinse=rinse, chip="h100")
               for mode, rinse in cs.MM_MODES]
    seen = set()
    for name, m, k, n, dtype in cs.MM_SHAPES:
        for eng in engines:
            _, sch = ops.resolve_schedule(
                m, k, n, str(dtype).removeprefix("torch."), engine=eng)
            launch, ks, splits = _launch(m, k, n, dtype, bk=sch["bk"],
                                         split_k=sch["split_k"])
            seen.add((name, launch.body, splits))
            if dtype == torch.float32:
                assert launch.body == "cuda_cores"
                assert launch.tile == (64, 64)
            elif m > 64:
                assert launch.body == "wgmma" and launch.tile == (256, 256)
                assert launch.ctas == 132 and launch.cluster == 2
                assert launch.units == (-(-m // 256)) * (-(-n // 256)) * splits
            else:
                assert launch.body == "small_m", name
                assert launch.ctas >= 132, (name, launch)
                assert launch.tile[1] in (32, 64, 128)
                assert launch.cluster in (1, 2, 4, 8)
                assert launch.ctas == launch.units * launch.cluster
                assert launch.units == -(-n // launch.tile[1]) * splits
                assert launch.kslice % 64 == 0 and launch.kslice >= 256
                assert launch.kslice * launch.cluster >= min(ks, k)
                assert launch.kslice * (launch.cluster - 1) < min(ks, k)
    # Both schedules reach both tensor-core bodies.
    assert {(b, s > 1) for _, b, s in seen} >= {
        ("wgmma", False), ("wgmma", True), ("small_m", False),
        ("small_m", True), ("cuda_cores", False)}


@pytest.mark.parametrize("case, want", [
    # ragged m above 64, n != k: wgmma, TMA masks the edges; pairs of
    # CTAs, one CTA an SM at most
    (dict(m=130, k=1024, n=520), ("wgmma", (256, 256), 6, 2)),
    (dict(m=300, k=2048, n=136, bk=128, split_k=3),
     ("wgmma", (256, 256), 12, 2)),
    (dict(m=4096, k=1024, n=4096, sms=131), ("wgmma", (256, 256), 130, 2)),
    # the largest small_m m; m 40 holds 64 rows, so no 128-column tile
    (dict(m=64, k=1024, n=520), ("small_m", (64, 32), 68, 4)),
    (dict(m=40, k=2048, n=136, split_k=2), ("small_m", (64, 32), 40, 4)),
    (dict(m=16, k=4096, n=1024), ("small_m", (64, 32), 256, 8)),
    (dict(m=16, k=11008, n=4096, split_k=5), ("small_m", (64, 128), 160, 1)),
    # a split K range that is not whole 64-deep stages: no TMA
    (dict(m=256, k=1000, n=256, bk=200, split_k=2),
     ("cp_async", (128, 128), 8, 1)),
    # unaligned row strides or bases, and odd k: the masked body
    (dict(m=200, k=1000, n=304, lda=1004), ("masked", (128, 128), 6, 1)),
    (dict(m=16, k=4096, n=4096, lda=4100), ("masked", (128, 128), 32, 1)),
    (dict(m=16, k=4096, n=4096, ldb=4100), ("masked", (128, 128), 32, 1)),
    (dict(m=512, k=4096, n=1024, aligned=False),
     ("masked", (128, 128), 32, 1)),
    (dict(m=200, k=999, n=304, split_k=2), ("masked", (128, 128), 12, 1)),
    (dict(m=130, k=70, n=90, dtype=torch.float32),
     ("cuda_cores", (64, 64), 6, 1)),
])
def test_launch_choice_at_ragged_and_unaligned_shapes(case, want):
    """The body, CTA tile, CTAs and cluster the wrapper picks by shape,
    row strides and alignment, on a 132-SM card."""
    case = dict(case)
    dtype = case.pop("dtype", torch.bfloat16)
    m, k, n = case.pop("m"), case.pop("k"), case.pop("n")
    launch, _, _ = _launch(m, k, n, dtype, **case)
    assert (launch.body, launch.tile, launch.ctas, launch.cluster) == want


def test_small_m_launch_follows_the_sm_count():
    """Fewer SMs take fewer CTAs: the cluster grows only while the CTAs are
    fewer than the SMs."""
    small, _, _ = _launch(16, 4096, 4096, torch.bfloat16, sms=16)
    assert (small.body, small.ctas, small.cluster) == ("small_m", 32, 1)
    big, _, _ = _launch(16384, 4096, 4096, torch.bfloat16, sms=16)
    assert (big.body, big.ctas, big.cluster) == ("wgmma", 16, 2)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the matmul kernel has no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("schedule", [
    dict(bm=512, bn=512, bk=512, split_k=1),
    dict(bm=128, bn=256, bk=128, split_k=3),
    dict(bm=16, bn=512, bk=512, split_k=2),
    dict(bm=256, bn=512, bk=256, split_k=5),
    dict(bm=256, bn=256, bk=200, split_k=2),
])
@pytest.mark.parametrize("mkn", [(256, 128, 256), (130, 70, 90),
                                 (16, 1024, 520), (300, 2048, 136),
                                 (64, 1024, 520), (16, 4096, 1024),
                                 (130, 1024, 520), (40, 2048, 136),
                                 (200, 1000, 304, 1004)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_matches_plain_on_the_card(card, dtype, mkn, schedule):
    """The kernel against its plain version on the card: ragged m, k and
    n, n != k, m 16 and 64 (small_m), a ragged m above 64 (wgmma; with
    split K ranges that are not whole 64-deep stages, cp_async), an
    unaligned row stride (a fourth entry: a's row stride; masked), both
    schedules with 2 to 5 splits summed in the kernel; ``mnk`` and ``nmk``
    bitwise equal, and a repeat bitwise equal."""
    m, k, n = mkn[:3]
    (_, _), (ta, tb) = _inputs(5, m, mkn[3] if len(mkn) > 3 else k, n,
                               dtype)
    ta, tb = ta[:, :k].cuda(), tb[:k].cuda()
    ks, splits = (mk.split_ranges(k, min(schedule["bk"], k),
                                  schedule["split_k"])
                  if schedule["split_k"] > 1 else (k, 1))
    want_body = ("cuda_cores" if dtype == "float32" else
                 "masked" if len(mkn) > 3 or k % 8 or n % 8 or ks % 8 else
                 "small_m" if m <= 64 else
                 "cp_async" if splits > 1 and ks % 64 else "wgmma")
    assert mk.launch_of(ta, tb, **schedule).body == want_body
    got = mk.matmul_cuda(ta, tb, order="mnk", **schedule)
    other = mk.matmul_cuda(ta, tb, order="nmk", **schedule)
    again = mk.matmul_cuda(ta, tb, order="mnk", **schedule)
    want = mk.matmul_plain(ta, tb, bk=schedule["bk"],
                           split_k=schedule["split_k"])
    torch.cuda.synchronize()
    np.testing.assert_allclose(_np(got.cpu()), _np(want.cpu()), **TOL[dtype])
    assert torch.equal(got, other) and torch.equal(got, again)
