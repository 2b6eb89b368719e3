"""The port's MoE grouped GEMM (plain version and the public op on CPU
tensors) held against the JAX package's Pallas kernel (interpret mode) and
its ``ref.py`` oracle on the reference's cases; rows past each count and
empty experts exactly 0; the CPU dispatch rule, the CUDA entry's input
guards, and the kernel's body choice by shape alone (``plan_launch``,
``launch_of``, ``grid_of``).  The kernel itself runs only on the card
(the ``cuda`` marker) and in ``chip_smoke.py``."""
import importlib.util
import pathlib

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


# (name, e, c, k, n, dtype, strides or None for contiguous, aligned, body):
# olmoe-1b-7b's prefill and decode products, the reference's ragged shape,
# an odd row stride, an unaligned base, a broadcast expert axis, fp32, and
# both sides of the decode body's 64 rows.
PLANS = [
    ("prefill", 64, 16384, 2048, 1024, "bfloat16", None, True, "wgmma"),
    ("prefill_wd", 64, 16384, 1024, 2048, "bfloat16", None, True, "wgmma"),
    ("decode", 64, 16, 2048, 1024, "bfloat16", None, True, "decode"),
    ("decode_wd", 64, 16, 1024, 2048, "bfloat16", None, True, "decode"),
    ("ragged", 8, 100, 200, 130, "bfloat16", None, True, "wmma"),
    ("odd_row_stride", 4, 256, 128, 256, "bfloat16",
     (256 * 129, 129, 128 * 256, 256), True, "wmma"),
    ("unaligned_base", 4, 256, 128, 256, "bfloat16", None, False, "wmma"),
    ("broadcast_experts", 4, 256, 128, 256, "bfloat16",
     (0, 128, 128 * 256, 256), True, "wmma"),
    ("fp32", 64, 16384, 2048, 1024, "float32", None, True, "cuda_cores"),
    ("c64", 8, 64, 2048, 1024, "bfloat16", None, True, "decode"),
    ("c65", 8, 65, 2048, 1024, "bfloat16", None, True, "wgmma"),
]


@pytest.mark.parametrize("name, e, c, k, n, dtype, strides, aligned, body",
                         PLANS, ids=[p[0] for p in PLANS])
def test_plan_launch_picks_the_body_by_shape(name, e, c, k, n, dtype,
                                             strides, aligned, body):
    strides = strides or (c * k, k, k * n, n)
    assert gk.plan_launch(e, c, k, n, TDT[dtype], strides=strides,
                          aligned=aligned) == body


def test_launch_of_reads_shapes_strides_and_bases():
    """``launch_of`` asks ``plan_launch`` with the tensors' own strides and
    base alignment (CPU tensors: nothing is launched)."""
    x = torch.zeros(4, 100, 64, dtype=torch.bfloat16)
    w = torch.zeros(4, 64, 256, dtype=torch.bfloat16)
    assert gk.launch_of(x, w) == "wgmma"
    assert gk.launch_of(x[:, :16], w) == "decode"       # a row slice
    wide = torch.zeros(4, 100, 72, dtype=torch.bfloat16)
    assert gk.launch_of(wide[:, :, 8:], w) == "wgmma"   # 16-byte offset
    assert gk.launch_of(wide[:, :, 4:68], w) == "wmma"  # 8-byte offset
    odd = torch.zeros(4, 100, 66, dtype=torch.bfloat16)
    assert gk.launch_of(odd[:, :, :64], w) == "wmma"    # row stride 66
    assert gk.launch_of(x.float(), w.float()) == "cuda_cores"


@pytest.mark.parametrize("shape, dtype, body", [
    ((4, 100, 64, 256), "bfloat16", "wgmma"),
    ((4, 16, 64, 256), "bfloat16", "decode"),
    ((4, 100, 64, 130), "bfloat16", "wmma"),
    ((4, 100, 64, 256), "float32", "cuda_cores")], ids=lambda v: str(v))
def test_body_ignores_counts(shape, dtype, body):
    """The body is chosen by shape alone: no count, wherever it falls
    against the row tiles, changes it."""
    e, c, k, n = shape
    x = torch.zeros(e, c, k, dtype=TDT[dtype])
    w = torch.zeros(e, k, n, dtype=TDT[dtype])
    bodies = {gk.launch_of(x, w, counts) for counts in (
        None, torch.zeros(e, dtype=torch.int32),
        torch.full((e,), c, dtype=torch.int32),
        torch.tensor([0, 1, c // 2, c], dtype=torch.int32))}
    assert bodies == {body}


def test_chip_smoke_cases_name_the_planned_body():
    """Every ``kernels_gmm`` case of ``chip_smoke.py`` names, for bf16, the
    body ``plan_launch`` picks for its contiguous, aligned tensors (the
    card run checks the body that ran against both); fp32 takes
    ``cuda_cores``."""
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_gmm", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    assert {case[0] for case in cs.GMM_CASES} >= {
        "prefill", "prefill_wd", "decode", "decode_wd", "ragged",
        "prefill_edge", "prefill_counts"}
    for name, e, c, k, n, _, body in cs.GMM_CASES:
        strides = (c * k, k, k * n, n)
        for dtype, want in ((torch.bfloat16, body),
                            (torch.float32, "cuda_cores")):
            assert gk.plan_launch(e, c, k, n, dtype, strides=strides,
                                  aligned=True) == want, (name, dtype)


@pytest.mark.parametrize("body, shape, grid", [
    ("wgmma", (64, 16384, 1024), (16384, 132, 2)),
    ("wgmma", (2, 100, 130), (2, 4, 2)),
    ("decode", (64, 16, 1024), (512, 512, 1)),
    ("decode", (64, 16, 2048), (1024, 1024, 1)),
    ("wmma", (8, 100, 130), (16, 16, 1)),
    ("cuda_cores", (64, 16384, 1024), (262144, 262144, 1))],
    ids=lambda v: str(v))
def test_grid_of(body, shape, grid):
    """The wgmma grid is persistent (at most the resident CTAs, in pairs);
    the decode body runs a CTA an (expert, 128-column tile)."""
    assert gk.grid_of(body, *shape, resident=132) == gk.Grid(*grid)


def _gmm_case(seed, e, c, k, n, dtype, counts):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(e, c, k, generator=gen, device="cuda").to(TDT[dtype])
    w = (torch.randn(e, k, n, generator=gen, device="cuda")
         * k ** -0.5).to(TDT[dtype])
    tc = (None if counts is None
          else torch.tensor(counts, dtype=torch.int32, device="cuda"))
    return x, w, tc


# (e, c, k, n, counts, body): chip_smoke.py's prefill case at a c that is
# no multiple of 256 (the tensor maps' zero fill at c's edge) and its
# counts case (counts 0, c, and inside a row tile: a dead CTA of the
# cluster, a dead warpgroup, one live row), at a small width; the decode
# body with a dead expert and a partial row tile.
BODY_CASES = [
    (4, 1000, 256, 256, None, "wgmma"),
    (8, 520, 128, 256, [0, 520, 1, 127, 128, 129, 255, 300], "wgmma"),
    (4, 48, 256, 192, [0, 48, 17, 33], "decode"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", BODY_CASES, ids=lambda v: str(v[:4]))
def test_kernel_bodies_match_plain_on_the_card(card, dtype, case):
    """Each bf16 body against the plain version on the card, rows past the
    counts exactly 0, the body the plan names, repeated calls bitwise."""
    e, c, k, n, counts, body = case
    x, w, tc = _gmm_case(9, e, c, k, n, dtype, counts)
    want_body = body if dtype == "bfloat16" else "cuda_cores"
    assert gk.launch_of(x, w, tc) == want_body
    gk.reset_counters()
    got = gk.grouped_matmul_cuda(x, w, tc)
    again = gk.grouped_matmul_cuda(x, w, tc)
    want = gk.grouped_matmul_plain(x, w, tc)
    torch.cuda.synchronize()
    assert gk.grouped_matmul.body_launches[want_body] == 2
    assert torch.equal(got, again)
    np.testing.assert_allclose(_np(got.cpu()), _np(want.cpu()), **TOL[dtype])
    if tc is not None:
        rows = torch.arange(c, device="cuda")[None, :] >= tc[:, None]
        assert float(got.float().abs()[rows].max()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("case", [(4, 300, 128, 256, [0, 300, 5, 200]),
                                  (4, 40, 128, 136, [0, 40, 5, 17])],
                         ids=["wgmma", "decode"])
def test_kernel_bf16_to_fp32_out_on_the_card(card, case):
    """bf16 inputs, fp32 output: the wgmma body's epilogue stores fp32
    boxes, the decode body fp32 pairs; both match the plain version."""
    e, c, k, n, counts = case
    x, w, tc = _gmm_case(10, e, c, k, n, "bfloat16", counts)
    got = gk.grouped_matmul_cuda(x, w, tc, out_dtype=torch.float32)
    want = gk.grouped_matmul_plain(x, w, tc, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               **TOL["float32"])
    rows = torch.arange(c, device="cuda")[None, :] >= tc[:, None]
    assert float(got.abs()[rows].max()) == 0.0
