"""The port's fused norm (plain PyTorch version on the CPU) held against the
JAX package's Pallas kernel (interpret mode), its oracle and
``apply_norm``; the CPU dispatch rule, the CUDA entry's input guards, and
the weight bridge running the kernel path."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.fused_norm import ref as jref  # noqa: E402
from repro.kernels.fused_norm.ops import fused_norm as jfused  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.models import common as jcm  # noqa: E402
from repro.models import get_config as jax_config  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention as fk  # noqa: E402
from repro_torch.kernels.fused_norm import fused_norm as nk  # noqa: E402
from repro_torch.kernels.fused_norm import ops, ref  # noqa: E402
from repro_torch.models import build_model, get_config  # noqa: E402
from repro_torch.models import common as cm  # noqa: E402

torch.set_num_threads(1)

# The reference's tolerances (tests/test_kernels.py): both sides round
# their inputs to the same values; the sums run in another order.
TOL = {"float32": dict(rtol=2e-3, atol=2e-3),
       "bfloat16": dict(rtol=3e-2, atol=3e-2)}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _both(x, dtype):
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(x).astype(jdt), torch.from_numpy(x).to(tdt)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _case(seed, shape):
    rng = np.random.default_rng(seed)
    d = shape[-1]
    return (rng.standard_normal(shape, np.float32),
            rng.standard_normal(d, np.float32),
            rng.standard_normal(d, np.float32),
            rng.standard_normal(shape, np.float32))


# Every rms/layer x residual x bias combination on a ragged row count
# (400 rows: the Pallas kernel pads its 256-row blocks), plus the decode
# shape (b, 1, d) and a 2-D input on two of them.
_CASES = [((4, 100, 512), kind, residual, bias)
          for kind in ("rms", "layer") for residual in (False, True)
          for bias in (False, True)]
_CASES += [(shape, kind, True, kind == "layer")
           for shape in ((3, 1, 96), (300, 256)) for kind in ("rms", "layer")]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape, kind, residual, bias", _CASES)
def test_plain_and_ref_match_jax_kernel_and_oracle(dtype, shape, kind,
                                                   residual, bias):
    x, w, b, r = _case(0, shape)
    jx, tx = _both(x, dtype)
    jr, tr = _both(r, dtype) if residual else (None, None)
    jw, tw = jnp.asarray(w), torch.from_numpy(w)
    jb, tb = (jnp.asarray(b), torch.from_numpy(b)) if bias else (None, None)
    want_kernel = jfused(jx, jw, jb, jr, kind=kind, interpret=True)
    want_ref = jref.fused_norm(jx, jw, jb, jr, kind=kind)
    got = nk.fused_norm_plain(tx, tw, tb, tr, kind=kind)
    got_ref = ref.fused_norm(tx, tw, tb, tr, kind=kind)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    for want in (want_kernel, want_ref):
        np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])
        np.testing.assert_allclose(_np(got_ref), _np(want), **TOL[dtype])


@pytest.mark.parametrize("kind", ["rms", "layer"])
def test_kernel_route_norm_matches_jax_apply_norm(kind):
    """``apply_norm`` on a kernel route (the fused norm's plain version on
    the CPU) against the reference's ``apply_norm``, and bitwise against
    the port's own plain ``xla`` route."""
    cfg = dataclasses.replace(get_config("yi-9b", smoke=True),
                              norm_kind=kind, decode_kernel="pallas_paged")
    rng = np.random.default_rng(1)
    h = rng.standard_normal((2, 5, cfg.d_model)).astype(np.float32)
    p = {"w": rng.standard_normal(cfg.d_model).astype(np.float32)}
    if kind == "layer":
        p["b"] = rng.standard_normal(cfg.d_model).astype(np.float32)
    tp = {k: torch.from_numpy(a) for k, a in p.items()}
    nk.reset_counters()
    got = cm.apply_norm(tp, torch.from_numpy(h), cfg)
    assert nk.fused_norm_plain.calls == 1
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jcm.apply_norm(p, h, cfg)),
                               rtol=1e-5, atol=1e-5)
    plain = cm.apply_norm(tp, torch.from_numpy(h),
                          dataclasses.replace(cfg, decode_kernel="xla"))
    assert torch.equal(got, plain)


def test_cpu_wrapper_takes_the_plain_version():
    x, w, b, r = (torch.from_numpy(a) for a in _case(2, (3, 64)))
    nk.reset_counters()
    ops.fused_norm(x, w, b, r, kind="layer")
    ops.fused_norm(x, w)
    assert nk.fused_norm_plain.calls == 2 and nk.fused_norm.launches == 0


def _guard_case():
    x, w, b, r = (torch.from_numpy(a) for a in _case(3, (4, 64)))
    return dict(x=x, weight=w, bias=b, residual=r)


@pytest.mark.parametrize("change, message", [
    ({}, "CUDA tensors only"),
    ({"x": lambda a: a["x"].double(),
      "residual": lambda a: a["residual"].double()}, "not supported"),
    ({"residual": lambda a: a["residual"].bfloat16()}, "residual must match"),
    ({"bias": lambda a: a["bias"].bfloat16()}, "bias dtype"),
    ({"weight": lambda a: a["weight"][:32]}, "must be \\(64,\\)"),
    ({"x": lambda a: a["x"].t().contiguous().t(),
      "residual": lambda a: a["residual"].t().contiguous().t()},
     "contiguous"),
    ({"x": lambda a: torch.zeros(2, 8193),
      "weight": lambda a: torch.zeros(8193), "bias": lambda a: None,
      "residual": lambda a: None}, "row width"),
    ({"kind": lambda a: "batch"}, "kind must be"),
])
def test_cuda_entry_refuses_what_the_kernel_does_not_take(change, message):
    """The CUDA-only entry raises, naming the problem; it never falls back
    to the plain version (CPU tensors are refused too)."""
    args = _guard_case()
    kind = "layer"
    for key, fn in change.items():
        if key == "kind":
            kind = fn(args)
        else:
            args[key] = fn(args)
    nk.reset_counters()
    with pytest.raises(ValueError, match=message):
        nk.fused_norm_cuda(**args, kind=kind)
    assert nk.fused_norm_plain.calls == 0 and nk.fused_norm.launches == 0


@pytest.mark.parametrize("arch", ["qwen2.5-32b", "yi-9b"])
def test_from_jax_params_run_the_kernel_path(arch):
    """``convert.from_jax`` output served through ``pallas_paged`` on the
    CPU: every norm and the prefill attention take their kernels' plain
    versions, and the logits match the JAX model's (norm weights moved off
    one so the bridge of every norm is tested)."""
    over = dict(cache_layout="paged", kv_page_size=8,
                decode_kernel="pallas_paged", decode_splits=2)
    jcfg = dataclasses.replace(jax_config(arch, smoke=True), **over)
    tcfg = dataclasses.replace(get_config(arch, smoke=True), **over)
    jparams = jax_build(jcfg).init(jax.random.PRNGKey(3))
    rng = np.random.default_rng(4)
    jparams = jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32)
        + 0.1 * rng.standard_normal(np.shape(a)).astype(np.float32), jparams)
    tparams = convert.from_jax(jparams, tcfg, "cpu")
    jm, tm = jax_build(jcfg), build_model(tcfg, "cpu")
    table = np.array([[3, 0, 5], [1, 4, 2]], np.int32)
    jcache = jm.init_cache(jparams, batch=2, max_len=24)
    tcache = tm.init_cache(tparams, batch=2, max_len=24)
    jcache["pages"] = jnp.asarray(table)
    tcache["pages"] = torch.from_numpy(table)
    toks = rng.integers(0, jcfg.vocab, (2, 16)).astype(np.int32)
    seg = np.array([16, 11], np.int32)
    nk.reset_counters()
    fk.reset_counters()
    jl, _ = jax.jit(jm.prefill)(jparams, jcache, jnp.asarray(toks),
                                seg_lens=jnp.asarray(seg))
    tl, _ = tm.prefill(tparams, tcache, torch.from_numpy(toks),
                       seg_lens=torch.from_numpy(seg))
    assert nk.fused_norm_plain.calls == 2 * tcfg.n_layers + 1
    assert fk.paged_flash_attention_plain.calls == tcfg.n_layers
    assert fk.flash_attention_plain.calls == 0
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=2e-3,
                               atol=2e-3)


# (tpr, vectors a thread) the wrapper picks for each ported width at a
# 16 x 1024 prefill wave: the fewest threads a row that leave each thread
# at most 5 vectors of 16 bytes (8 bf16, 4 fp32).
_PREFILL_SHAPES = {
    torch.bfloat16: {2048: (64, 4), 2560: (64, 5), 4096: (128, 4),
                     5120: (128, 5), 64: (32, 1)},
    torch.float32: {2048: (128, 4), 2560: (128, 5), 64: (32, 1)},
}


def test_cuda_entry_checks_inputs_under_a_given_launch():
    """A launch passed in (the scalar plan, as chip_smoke.py times it) does
    not skip the input guards."""
    args = _guard_case()
    scalar = nk.plan_launch(4, 64, torch.float32, aligned=False)
    nk.reset_counters()
    with pytest.raises(ValueError, match="CUDA tensors only"):
        nk.fused_norm_cuda(**args, kind="layer", launch=scalar)
    assert nk.fused_norm_plain.calls == 0 and nk.fused_norm.launches == 0


@pytest.mark.parametrize("arch", ["yi-9b", "qwen2.5-32b", "mamba2-1.3b",
                                  "zamba2-2.7b", "olmoe-1b-7b",
                                  "phi3.5-moe-42b-a6.6b"])
@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_plan_launch_at_every_served_width(arch, smoke, dtype):
    """The body and launch shape at each ported config's norm width and at
    its SMOKE width, for a prefill wave (16 x 1024 rows) and a decode step
    (16 rows): the vector body, the row held whole in registers, several
    rows a block at prefill, 4 blocks an SM or more (at most 8 groups of
    rows a block) striding over them.  fp32 rows of a whole block (d over
    2560) that fill the card take the scalar body."""
    d = get_config(arch, smoke=smoke).d_model
    per = 8 if dtype == torch.bfloat16 else 4     # elements a vector
    pre = nk.plan_launch(16 * 1024, d, dtype, aligned=True)
    launches = []
    if dtype == torch.float32 and d > 2560:
        assert (pre.body, pre.ctas, pre.rows_per_cta) == (
            "scalar", 16 * 1024, 1)
    else:
        assert (pre.body, (pre.tpr, pre.vec)) == (
            "vector", _PREFILL_SHAPES[dtype][d])
        groups = 16 * 1024 // (256 // pre.tpr)        # rows a block at once
        assert pre.ctas == max(4 * 132, -(-groups // 8))
        assert pre.rows_per_cta <= 8 * 256 // pre.tpr
        assert pre.ctas * pre.rows_per_cta >= 16 * 1024
        launches.append(pre)
    dec = nk.plan_launch(16, d, dtype, aligned=True)
    assert dec.body == "vector" and dec.vec <= 5
    assert dec.ctas * dec.rows_per_cta >= 16
    for launch in launches + [dec]:
        assert launch.tpr in (32, 64, 128, 256)
        assert launch.tpr * launch.vec * per >= d > (
            launch.vec - 1) * per * launch.tpr


def test_plan_launch_widens_rows_of_a_decode_step():
    """16 rows of 4096: 256 threads a row (16 blocks, 2 vectors each) in
    place of 128 (8 blocks), since the blocks are fewer than the SMs."""
    launch = nk.plan_launch(16, 4096, torch.bfloat16, aligned=True)
    assert (launch.tpr, launch.vec, launch.ctas, launch.rows_per_cta) == (
        256, 2, 16, 1)


@pytest.mark.parametrize("d, aligned, dtype", [
    (4096, False, torch.bfloat16), (100, True, torch.bfloat16),
    (4100, True, torch.bfloat16), (6144, True, torch.float32),
    (8192, True, torch.float32)])
def test_plan_launch_takes_the_scalar_body(d, aligned, dtype):
    """Rows that are not 16-byte aligned, d % 8 != 0, or rows that 256
    threads of 5 vectors do not cover (fp32 past 5120): a block a row."""
    launch = nk.plan_launch(300, d, dtype, aligned=aligned)
    assert (launch.body, launch.tpr, launch.vec, launch.ctas,
            launch.rows_per_cta) == ("scalar", 256, 0, 300, 1)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the fused norm has no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(3, 700, 2048), (16, 1, 4096),
                                   (5, 7, 5120), (4, 3, 64), (9, 100)])
@pytest.mark.parametrize("kind", ["rms", "layer"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_matches_plain_on_the_card(card, shape, kind, dtype):
    """Both bodies (vector where d % 8 == 0, scalar at d 100 and on a view
    one element off alignment) against the plain version, with residual
    and bias, fp32 and bf16 weights."""
    tdt = DTYPES[dtype][1]
    x, w, b, r = (torch.from_numpy(a).cuda() for a in _case(5, shape))
    x, r = x.to(tdt), r.to(tdt)
    for wdt in (torch.float32, torch.bfloat16):
        wt, bt = w.to(wdt), (b.to(wdt) if kind == "layer" else None)
        got = nk.fused_norm_cuda(x, wt, bt, r, kind=kind)
        want = nk.fused_norm_plain(x, wt, bt, r, kind=kind)
        want_body = "vector" if shape[-1] % 8 == 0 else "scalar"
        assert nk.launch_of(x, wt, bt, r, kind=kind).body == want_body
        atol, rtol = (2e-3, 2e-3) if dtype == "float32" else (4e-3, 2 ** -7)
        torch.testing.assert_close(got.float(), want.float(), atol=atol,
                                   rtol=rtol)
    flat = torch.cat([x.reshape(-1), x.reshape(-1)[:1]])[1:].reshape(x.shape)
    wt = w.to(torch.float32)
    assert nk.launch_of(flat, wt, kind=kind).body == "scalar"
    torch.testing.assert_close(
        nk.fused_norm_cuda(flat, wt, kind=kind).float(),
        nk.fused_norm_plain(flat, wt, kind=kind).float(),
        atol=4e-3, rtol=2 ** -7)
