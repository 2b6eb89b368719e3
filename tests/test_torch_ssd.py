"""The port's SSD scan (plain PyTorch version on the CPU) held against the
JAX package's sequential oracle, its Pallas kernel (interpret mode) and
``ssd_chunked``, with and without an initial state; the bitwise identity
of dt = 0 rows; ``ssd_decode_step``; the CPU dispatch rule and the CUDA
entry's input guards.  The kernel itself runs only on the card (the
``cuda`` marker) and in ``chip_smoke.py``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.ssd import ref as jref  # noqa: E402
from repro.kernels.ssd.ops import ssd as jssd  # noqa: E402
from repro.kernels.ssd.ssd import ssd_decode_step as jdecode  # noqa: E402
from repro.models.mamba2 import ssd_chunked as jchunked  # noqa: E402
from repro_torch.kernels.ssd import ops, ref  # noqa: E402
from repro_torch.kernels.ssd import ssd as sk  # noqa: E402

torch.set_num_threads(1)
F32 = dict(rtol=2e-3, atol=2e-3)

# The reference's cases (tests/test_kernels.py TestSSD):
# (b, l, h, dh, g, ds, chunk).
CASES = [(2, 128, 4, 32, 2, 16, 32), (1, 100, 2, 64, 1, 32, 32),
         (2, 64, 8, 32, 8, 16, 16)]


def _inputs(seed, b, l, h, dh, g, ds):
    rng = np.random.default_rng(seed)

    def r(*s):
        return rng.standard_normal(s).astype(np.float32)

    return dict(x=r(b, l, h, dh), dt=np.log1p(np.exp(r(b, l, h))),
                A=-np.exp(r(h)), B=r(b, l, g, ds), C=r(b, l, g, ds), D=r(h),
                S0=r(b, h, ds, dh))


def _t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("case", CASES)
def test_plain_matches_jax_oracle_and_pallas_kernel(case):
    b, l, h, dh, g, ds, chunk = case
    a = _inputs(0, b, l, h, dh, g, ds)
    args = [a[k] for k in ("x", "dt", "A", "B", "C", "D")]
    yr, Sr = jref.ssd(*args)
    yk, Sk = jssd(*args, chunk=chunk, interpret=True)
    y, S = sk.ssd_plain(*map(_t, args), chunk=chunk)
    yo, So = ref.ssd(*map(_t, args))
    for want_y, want_s in ((yr, Sr), (yk, Sk)):
        np.testing.assert_allclose(y.numpy(), np.asarray(want_y), **F32)
        np.testing.assert_allclose(S.numpy(), np.asarray(want_s), **F32)
    np.testing.assert_allclose(yo.numpy(), np.asarray(yr), **F32)
    np.testing.assert_allclose(So.numpy(), np.asarray(Sr), **F32)


@pytest.mark.parametrize("case", CASES)
def test_plain_with_init_state_matches_jax(case):
    """A nonzero ``init_state`` (what every serve prefill carries) against
    ``ref.ssd(init_state=...)`` and the reference's ``ssd_chunked``."""
    b, l, h, dh, g, ds, chunk = case
    a = _inputs(1, b, l, h, dh, g, ds)
    args = [a[k] for k in ("x", "dt", "A", "B", "C", "D")]
    yr, Sr = jref.ssd(*args, init_state=a["S0"])
    yc, Sc = jchunked(*args, chunk=chunk, init_state=a["S0"])
    y, S = sk.ssd_plain(*map(_t, args), chunk=chunk, init_state=_t(a["S0"]))
    yo, So = ref.ssd(*map(_t, args), init_state=_t(a["S0"]))
    for want_y, want_s in ((yr, Sr), (yc, Sc)):
        np.testing.assert_allclose(y.numpy(), np.asarray(want_y), **F32)
        np.testing.assert_allclose(S.numpy(), np.asarray(want_s), **F32)
    np.testing.assert_allclose(yo.numpy(), np.asarray(yr), **F32)
    np.testing.assert_allclose(So.numpy(), np.asarray(Sr), **F32)


@pytest.mark.parametrize("chunk", [16, 128])
def test_dt_zero_tail_and_parked_slot_keep_state_bitwise(chunk):
    """Slot 0 ends in a ragged dt-zero tail: whatever x, B and C hold
    there, its state and its valid rows of y are bitwise those of a tail
    of zeros, and match its valid prefix run alone.  Slot 1 is parked
    (dt = 0 everywhere): its final state is its init_state, bit for bit."""
    b, l, h, dh, g, ds = 2, 40, 4, 16, 2, 16
    a = _inputs(2, b, l, h, dh, g, ds)
    n = 23
    dt = a["dt"].copy()
    dt[0, n:] = 0.0
    dt[1] = 0.0
    args = [_t(a["x"]), _t(dt), _t(a["A"]), _t(a["B"]), _t(a["C"]),
            _t(a["D"])]
    S0 = _t(a["S0"])
    y, S = ops.ssd(*args, chunk=chunk, init_state=S0)
    assert torch.equal(S[1], S0[1])
    zeroed = [t.clone() for t in args]
    for i in (0, 3, 4):
        zeroed[i][0, n:] = 0.0
    y_z, S_z = ops.ssd(*zeroed, chunk=chunk, init_state=S0)
    assert torch.equal(S[0], S_z[0])
    assert torch.equal(y[0, :n], y_z[0, :n])
    head = [t[:1, :n] for t in args[:2]] + [args[2]] + [
        t[:1, :n] for t in args[3:5]] + [args[5]]
    y_head, S_head = sk.ssd_plain(*head, chunk=chunk, init_state=S0[:1])
    np.testing.assert_allclose(S[0].numpy(), S_head[0].numpy(), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(y[0, :n].numpy(), y_head[0].numpy(),
                               rtol=1e-5, atol=1e-5)
    # The decode step with dt = 0 is the identity on the state, too.
    _, S1 = sk.ssd_decode_step(args[0][:, 0], torch.zeros(b, h), args[2],
                               args[3][:, 0], args[4][:, 0], args[5], S0)
    assert torch.equal(S1, S0)


def test_decode_step_matches_jax():
    b, h, dh, g, ds = 2, 4, 32, 2, 16
    a = _inputs(3, b, 1, h, dh, g, ds)
    args = (a["x"][:, 0], a["dt"][:, 0], a["A"], a["B"][:, 0], a["C"][:, 0])
    for D in (None, a["D"]):
        yj, Sj = jdecode(*args, D, a["S0"])
        y, S = sk.ssd_decode_step(*map(_t, args), _t(D), _t(a["S0"]))
        np.testing.assert_allclose(y.numpy(), np.asarray(yj), **F32)
        np.testing.assert_allclose(S.numpy(), np.asarray(Sj), **F32)
    # One decode step equals the one-row scan from the same state.
    y1, S1 = sk.ssd_plain(*(_t(a[k]) for k in ("x", "dt", "A", "B", "C",
                                                "D")),
                          init_state=_t(a["S0"]))
    y, S = sk.ssd_decode_step(*map(_t, args), _t(a["D"]), _t(a["S0"]))
    np.testing.assert_allclose(y.numpy(), y1[:, 0].numpy(), **F32)
    np.testing.assert_allclose(S.numpy(), S1.numpy(), **F32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_jax_ssd_chunked_on_strided_views(dtype):
    """The model's call: x, B and C as strided views of one conv output,
    the reference's chunk rule, a length that is not a multiple of it."""
    b, l, h, dh, g, ds = 2, 150, 4, 8, 2, 8
    rng = np.random.default_rng(4)
    xbc = rng.standard_normal((b, l, h * dh + 2 * g * ds)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, l, h)))).astype(np.float32)
    A = -np.exp(rng.standard_normal(h)).astype(np.float32)
    D = rng.standard_normal(h).astype(np.float32)
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]

    def split(t):
        di = h * dh
        return (t[..., :di].reshape(b, l, h, dh),
                t[..., di:di + g * ds].reshape(b, l, g, ds),
                t[..., di + g * ds:].reshape(b, l, g, ds))

    jx, jB, jC = split(jnp.asarray(xbc).astype(jdt))
    tx, tB, tC = split(torch.from_numpy(xbc).to(tdt))
    assert not tx.is_contiguous()
    yj, Sj = jchunked(jx, dt, A, jB, jC, D, chunk=128)
    y, S = sk.ssd_plain(tx, _t(dt), _t(A), tB, tC, _t(D), chunk=128)
    tol = F32 if dtype == "float32" else dict(rtol=3e-2, atol=3e-2)
    np.testing.assert_allclose(y.float().numpy(),
                               np.asarray(yj.astype(jnp.float32)), **tol)
    np.testing.assert_allclose(S.numpy(), np.asarray(Sj), **tol)


def test_cpu_wrapper_takes_the_plain_version():
    a = _inputs(5, 1, 8, 2, 4, 1, 4)
    args = [_t(a[k]) for k in ("x", "dt", "A", "B", "C", "D")]
    sk.reset_counters()
    ops.ssd(*args)
    ops.ssd(*args[:5], init_state=_t(a["S0"]))
    assert sk.ssd_plain.calls == 2 and sk.ssd.launches == 0


def _guard_args():
    a = _inputs(6, 2, 8, 4, 8, 2, 8)
    return {k: _t(a[k]) for k in ("x", "dt", "A", "B", "C", "D")} | {
        "init_state": _t(a["S0"])}


@pytest.mark.parametrize("change, message", [
    ({}, "CUDA tensors only"),
    ({"x": lambda a: a["x"].double()}, "must share a dtype"),
    ({"B": lambda a: a["B"].bfloat16(), "C": lambda a: a["C"].bfloat16()},
     "must share a dtype"),
    ({"dt": lambda a: a["dt"][:, :4]}, "shapes disagree"),
    ({"x": lambda a: a["x"][:, :, :3], "dt": lambda a: a["dt"][:, :, :3],
      "A": lambda a: a["A"][:3], "D": lambda a: a["D"][:3],
      "init_state": lambda a: None}, "a multiple of groups"),
    ({"B": lambda a: a["B"][..., :6], "C": lambda a: a["C"][..., :6],
      "init_state": lambda a: None}, "multiple of 4"),
    ({"x": lambda a: torch.zeros(2, 8, 4, 136),
      "init_state": lambda a: None}, "at most 128"),
    ({"x": lambda a: a["x"].transpose(1, 3).contiguous().transpose(1, 3)},
     "contiguous"),
    ({"dt": lambda a: a["dt"].double()}, "dt must be float32"),
    ({"A": lambda a: a["A"][:2]}, "A must be a contiguous"),
    ({"init_state": lambda a: a["init_state"][:1]},
     "init_state must be a contiguous"),
])
def test_cuda_entry_refuses_what_the_kernel_does_not_take(change, message):
    """The CUDA-only entry raises, naming the problem; it never falls back
    to the plain version (CPU tensors are refused too)."""
    args = _guard_args()
    for key, fn in change.items():
        args[key] = fn(args)
    sk.reset_counters()
    with pytest.raises(ValueError, match=message):
        sk.ssd_cuda(args.pop("x"), args.pop("dt"), args.pop("A"),
                    args.pop("B"), args.pop("C"), args.pop("D"), **args)
    assert sk.ssd_plain.calls == 0 and sk.ssd.launches == 0


def test_smem_rule_matches_the_kernel_limits():
    """The wrapper's shared-memory rule admits both served shapes and
    refuses a state too wide for one block."""
    assert sk.smem_bytes(64, 128) == 138240           # mamba2-1.3b
    assert sk.smem_bytes(64, 64) == 88064             # zamba2-2.7b
    assert sk.smem_bytes(64, 256) > 232448


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the SSD kernel has no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_matches_plain_on_the_card(card, dtype):
    """The kernel against its plain version on the card, with a nonzero
    initial state and a parked slot (state bitwise)."""
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    a = _inputs(7, 3, 200, 4, 80, 2, 32)
    args = [_t(a[k]).cuda() for k in ("x", "dt", "A", "B", "C", "D")]
    args[1][2] = 0.0
    for i in (0, 3, 4):
        args[i] = args[i].to(tdt)
    S0 = _t(a["S0"]).cuda()
    y, S = sk.ssd_cuda(*args, init_state=S0)
    yp, Sp = sk.ssd_plain(*args, init_state=S0)
    assert torch.equal(S[2], S0[2])
    tol = F32 if dtype == "float32" else dict(rtol=2 ** -7, atol=4e-3)
    torch.testing.assert_close(y.float(), yp.float(), **tol)
    torch.testing.assert_close(S, Sp, **F32)
