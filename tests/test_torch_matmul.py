"""The port's policy-planned matmul (plain version and the public op on CPU
tensors) held against the JAX package's Pallas kernel (interpret mode) and
its ``ref.py`` oracle: the reference's cases (accumulating and split-K),
both grid orders, and engine-planned calls whose plans and resolved
schedules equal the reference's under STREAM output (split-K),
RESIDENT_ACCUM output (``cacherw``) and ``rinse=False`` (the column-major
order); the CPU dispatch rule and the CUDA entry's input guards.  The
kernel itself runs only on the card (the ``cuda`` marker) and in
``chip_smoke.py``."""
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


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the matmul kernel has no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("schedule", [
    dict(bm=512, bn=512, bk=512, split_k=1),
    dict(bm=128, bn=256, bk=128, split_k=3),
    dict(bm=16, bn=512, bk=512, split_k=2),
])
@pytest.mark.parametrize("mkn", [(256, 128, 256), (130, 70, 90),
                                 (16, 1024, 520), (300, 2048, 136)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_matches_plain_on_the_card(card, dtype, mkn, schedule):
    """The kernel against its plain version on the card: ragged m, k and
    n, the vector and the masked-load paths, both schedules; ``mnk`` and
    ``nmk`` bitwise equal, and a repeat bitwise equal."""
    (_, _), (ta, tb) = _inputs(5, *mkn, dtype)
    ta, tb = ta.cuda(), tb.cuda()
    got = mk.matmul_cuda(ta, tb, order="mnk", **schedule)
    other = mk.matmul_cuda(ta, tb, order="nmk", **schedule)
    again = mk.matmul_cuda(ta, tb, order="mnk", **schedule)
    want = mk.matmul_plain(ta, tb, bk=schedule["bk"],
                           split_k=schedule["split_k"])
    torch.cuda.synchronize()
    np.testing.assert_allclose(_np(got.cpu()), _np(want.cpu()), **TOL[dtype])
    assert torch.equal(got, other) and torch.equal(got, again)
