"""The port's MoE grouped GEMM (plain version and the public op on CPU
tensors) held against the JAX package's Pallas kernel (interpret mode) and
its ``ref.py`` oracle on the reference's cases; rows past each count and
empty experts exactly 0; the CPU dispatch rule and the CUDA entry's input
guards.  The kernel itself runs only on the card (the ``cuda`` marker) and
in ``chip_smoke.py``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.moe_gmm import ref as jref  # noqa: E402
from repro.kernels.moe_gmm.ops import grouped_matmul as jgmm  # noqa: E402
from repro_torch.kernels.moe_gmm import moe_gmm as gk  # noqa: E402
from repro_torch.kernels.moe_gmm import ops, ref  # noqa: E402

torch.set_num_threads(1)
# The reference's tolerances (tests/test_kernels.py TOL).
TOL = {"float32": dict(rtol=2e-3, atol=2e-3),
       "bfloat16": dict(rtol=3e-2, atol=3e-2)}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# The reference's cases (tests/test_kernels.py TestMoEGmm): (e, c, k, n).
CASES = [(4, 256, 128, 256), (8, 100, 200, 130)]


def _inputs(seed, e, c, k, n, with_counts=True):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((e, c, k)).astype(np.float32)
    w = rng.standard_normal((e, k, n)).astype(np.float32)
    counts = (rng.integers(0, c + 1, e).astype(np.int32) if with_counts
              else None)
    return x, w, counts


def _both(x, w, counts, dtype):
    """The same values as JAX and torch arrays of ``dtype`` (bf16 rounds
    the same fp32 numbers in both)."""
    jx, jw = (jnp.asarray(a).astype(JDT[dtype]) for a in (x, w))
    tx, tw = (torch.from_numpy(a).to(TDT[dtype]) for a in (x, w))
    jc = None if counts is None else jnp.asarray(counts)
    tc = None if counts is None else torch.from_numpy(counts)
    return (jx, jw, jc), (tx, tw, tc)


def _np(t):
    return t.float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ecKn", CASES)
def test_plain_matches_pallas_kernel_and_oracle(dtype, ecKn):
    x, w, counts = _inputs(5, *ecKn)
    (jx, jw, jc), (tx, tw, tc) = _both(x, w, counts, dtype)
    want_k = np.asarray(jgmm(jx, jw, jc, bm=64, bn=64, bk=64,
                             interpret=True), np.float32)
    want_r = np.asarray(jref.grouped_matmul(jx, jw, jc), np.float32)
    gk.reset_counters()
    got = ops.grouped_matmul(tx, tw, tc)
    assert got.dtype == TDT[dtype] and gk.grouped_matmul_plain.calls == 1
    for want in (want_k, want_r):
        np.testing.assert_allclose(_np(got), want, **TOL[dtype])
    np.testing.assert_allclose(_np(ref.grouped_matmul(tx, tw, tc)), want_r,
                               **TOL[dtype])
    rows = np.arange(ecKn[1])[None, :, None] >= counts[:, None, None]
    assert not np.any(_np(got)[np.broadcast_to(rows, got.shape)])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_no_counts_means_every_row_live(dtype):
    x, w, _ = _inputs(6, 3, 40, 48, 24, with_counts=False)
    (jx, jw, _), (tx, tw, _) = _both(x, w, None, dtype)
    want = np.asarray(jgmm(jx, jw, None, bm=64, bn=64, bk=64,
                           interpret=True), np.float32)
    got = ops.grouped_matmul(tx, tw)
    np.testing.assert_allclose(_np(got), want, **TOL[dtype])
    np.testing.assert_allclose(
        _np(ops.grouped_matmul(tx, tw, torch.full((3,), 40,
                                                  dtype=torch.int32))),
        _np(got), rtol=0, atol=0)


def test_empty_experts_write_zero():
    x = torch.ones((2, 64, 64))
    w = torch.ones((2, 64, 64))
    y = ops.grouped_matmul(x, w, torch.tensor([0, 64], dtype=torch.int32))
    assert float(y[0].abs().max()) == 0.0
    assert float(y[1].abs().min()) > 0.0


def test_out_dtype():
    x, w, counts = _inputs(7, 2, 16, 32, 8)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    got = ops.grouped_matmul(tx, tw, torch.from_numpy(counts),
                             out_dtype=torch.bfloat16)
    want = ref.grouped_matmul(tx, tw, torch.from_numpy(counts))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), want.numpy(), **TOL["bfloat16"])


def _guard_args():
    return dict(x=torch.zeros(2, 8, 16), w=torch.zeros(2, 16, 4),
                counts=torch.zeros(2, dtype=torch.int32), out_dtype=None)


@pytest.mark.parametrize("change, message", [
    (dict(x=lambda a: a["x"][0]), r"x \(e, c, k\)"),
    (dict(w=lambda a: torch.zeros(3, 16, 4)), "shapes disagree"),
    (dict(w=lambda a: torch.zeros(2, 15, 4)), "shapes disagree"),
    (dict(x=lambda a: torch.zeros(2, 0, 16)), "out of the kernel's range"),
    (dict(w=lambda a: a["w"].to(torch.bfloat16)), "share a dtype"),
    (dict(x=lambda a: a["x"].half(), w=lambda a: a["w"].half()),
     "share a dtype"),
    (dict(out_dtype=lambda a: torch.float16), "out_dtype"),
    (dict(x=lambda a: torch.zeros(2, 16, 8).transpose(1, 2)),
     "contiguous"),
    (dict(counts=lambda a: a["counts"].long()), "counts must be"),
    (dict(counts=lambda a: torch.zeros(3, dtype=torch.int32)),
     "counts must be"),
    ({}, "CUDA tensors only"),
])
def test_cuda_entry_refuses_what_the_kernel_does_not_take(change, message):
    """The CUDA-only entry raises, naming the problem; it never falls back
    to the plain version (CPU tensors are refused too)."""
    args = _guard_args()
    for key, fn in change.items():
        args[key] = fn(args)
    gk.reset_counters()
    with pytest.raises(ValueError, match=message):
        gk.grouped_matmul_cuda(args.pop("x"), args.pop("w"), **args)
    assert gk.grouped_matmul_plain.calls == 0
    assert gk.grouped_matmul.launches == 0


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the grouped-GEMM kernel has no CPU "
                    "mode")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ecKn", CASES + [(4, 33, 96, 96), (2, 16, 72, 40)])
def test_kernel_matches_plain_on_the_card(card, dtype, ecKn):
    """The kernel against its plain version on the card: ragged c, k and n,
    the vector and the masked-load paths, rows past each count exactly 0."""
    x, w, counts = _inputs(8, *ecKn)
    counts[0], counts[-1] = 0, ecKn[1]
    tx, tw = (torch.from_numpy(a).to("cuda", TDT[dtype]) for a in (x, w))
    tc = torch.from_numpy(counts).cuda()
    got = gk.grouped_matmul_cuda(tx, tw, tc)
    want = gk.grouped_matmul_plain(tx, tw, tc)
    torch.cuda.synchronize()
    np.testing.assert_allclose(_np(got.cpu()), _np(want.cpu()), **TOL[dtype])
    rows = torch.arange(ecKn[1], device="cuda")[None, :] >= tc[:, None]
    assert float(got.float().abs()[rows].max()) == 0.0
