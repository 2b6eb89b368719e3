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


def test_cuda_entry_checks_inputs_under_a_given_launch():
    """A launch passed in (the cuda_cores plan on bf16, as chip_smoke.py
    times it) does not skip the input guards."""
    args = _guard_args()
    fma = sk.plan_launch(2, 4, 8, 2, 8, torch.bfloat16, aligned=False)
    assert fma.body == "cuda_cores"
    sk.reset_counters()
    with pytest.raises(ValueError, match="CUDA tensors only"):
        sk.ssd_cuda(args.pop("x"), args.pop("dt"), args.pop("A"),
                    args.pop("B"), args.pop("C"), args.pop("D"), **args,
                    launch=fma)
    assert sk.ssd_plain.calls == 0 and sk.ssd.launches == 0


def test_smem_rule_matches_the_kernel_limits():
    """The wrapper's shared-memory rule admits both served shapes on both
    bodies and refuses a state too wide for the CUDA-core body's block:
    cuda_cores holds fp32 x, B, C, M and the state; mma two bf16 ring
    stages (x of hb heads, B, C, dt), C B^T and three vectors a head."""
    assert sk.smem_bytes(64, 128) == 138240           # mamba2-1.3b
    assert sk.smem_bytes(64, 64) == 88064             # zamba2-2.7b
    assert sk.smem_bytes(64, 256) > 232448
    assert sk.smem_bytes(64, 128, body="mma", hb=4) == 166912
    assert sk.smem_bytes(64, 64, body="mma", hb=4) == 134144
    # The mma body pads ds to 32, 64 or 128 and fits at every head count
    # its 16-warp cap allows.
    assert sk.smem_bytes(64, 40, body="mma", hb=1) == sk.smem_bytes(
        64, 64, body="mma", hb=1)
    for dh in range(16, 129, 16):
        hb_max = 16 // (dh // 16)
        assert sk.smem_bytes(dh, 128, body="mma", hb=hb_max) <= 232448
    # A state too wide for both bodies is refused before any launch.
    a = _inputs(8, 1, 8, 2, 64, 1, 256)
    with pytest.raises(ValueError, match="bytes of shared memory"):
        sk.ssd_cuda(*(_t(a[k]) for k in ("x", "dt", "A", "B", "C", "D")))


def _served(arch, smoke):
    from repro_torch.models import get_config

    cfg = get_config(arch, smoke=smoke)
    return cfg, (cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_groups,
                 cfg.ssm_state)


@pytest.mark.parametrize("arch, smoke, want", [
    # (body, heads a block, blocks) for bf16 at 16 slots.
    ("mamba2-1.3b", False, ("mma", 4, 256)),
    ("zamba2-2.7b", False, ("mma", 2, 640)),
    ("mamba2-1.3b", True, ("mma", 1, 128)),
    ("zamba2-2.7b", True, ("mma", 1, 128)),
])
def test_plan_launch_at_every_served_shape(arch, smoke, want):
    """The body and launch shape the wrapper picks at each ported config's
    SSD shape (16 slots, as the serve arms prefill) and at the SMOKE
    shapes: bf16 on the tensor cores with hb heads of one group a block
    (C B^T shared) and dh / 16 warps a head, fp32 on the CUDA cores.
    mamba2 (ds 128) holds one 16-warp block an SM; zamba2 (ds 64) two
    8-warp blocks, as many warps on a finer grid."""
    cfg, (h, dh, g, ds) = _served(arch, smoke)
    launch = sk.plan_launch(16, h, dh, g, ds, torch.bfloat16, aligned=True)
    assert (launch.body, launch.hb, launch.ctas) == want
    assert (h // g) % launch.hb == 0
    assert launch.threads == 32 * launch.hb * (dh // 16) <= 512
    assert launch.smem == sk.smem_bytes(dh, ds, body="mma", hb=launch.hb)
    assert launch.smem <= 232448
    fp32 = sk.plan_launch(16, h, dh, g, ds, torch.float32, aligned=True)
    assert (fp32.body, fp32.hb, fp32.ctas, fp32.threads) == (
        "cuda_cores", 1, 16 * h, 256)
    assert fp32.smem == sk.smem_bytes(dh, ds)


@pytest.mark.parametrize("dims, aligned, body", [
    ((64, 64, 1, 128), False, "cuda_cores"),   # a misaligned view
    ((64, 72, 1, 128), True, "cuda_cores"),    # dh not a multiple of 16
    ((64, 64, 1, 132), True, "cuda_cores"),    # ds past 128
    ((64, 64, 1, 36), True, "cuda_cores"),     # ds not a multiple of 8
    ((64, 64, 1, 40), True, "mma"),            # ds padded to 64
    ((32, 128, 1, 128), True, "mma"),          # dh 128: 8 warps a head
])
def test_plan_launch_falls_back_to_the_cuda_cores(dims, aligned, body):
    h, dh, g, ds = dims
    launch = sk.plan_launch(16, h, dh, g, ds, torch.bfloat16,
                            aligned=aligned)
    assert launch.body == body
    if body == "mma":
        assert launch.threads <= 512 and launch.ctas >= 132


def test_plan_launch_trades_heads_a_block_for_blocks():
    """At mamba2's widths one block of 4 heads (16 warps) fills an SM;
    with few batch rows the grid is too small for it and hb falls to 1
    (4 warps a block, two blocks an SM by shared memory)."""
    def hb(batch):
        return sk.plan_launch(batch, 64, 64, 1, 128, torch.bfloat16,
                              aligned=True).hb

    assert hb(16) == 4          # 256 blocks x 16 warps
    assert hb(8) == 4           # 128 x 16 warps; hb 1: 264 x 4 busy
    assert hb(4) == 1           # 256 x 4 warps; hb 4: 64 x 16
    assert hb(1) == 1           # 64 blocks: every hb keeps 256 busy


def _emulate_mma_body(x, dt, A, B, C, D, S0, *, split):
    """The mma body's chunk arithmetic in torch (64-row chunks, C B^T from
    the bf16 inputs in fp32) with its operand rounding: every fp32 operand
    of a bf16 product (M, S, w x) rounded to hi + lo (``split``) or to a
    single bf16."""
    q = sk.KERNEL_CHUNK
    b, l, h, dh = x.shape
    hpg = h // B.shape[2]

    def operand(v):        # hi = bf16(v), lo = bf16(v - hi), as csrc/ssd.cu
        hi = v.to(torch.bfloat16).float()
        return hi + (v - hi).to(torch.bfloat16).float() if split else hi

    S, ys = S0.clone(), []
    for c0 in range(0, l, q):
        xs, d_ = x[:, c0:c0 + q].float(), dt[:, c0:c0 + q]
        bs = B[:, c0:c0 + q].float().repeat_interleave(hpg, 2)
        cs = C[:, c0:c0 + q].float().repeat_interleave(hpg, 2)
        n = xs.shape[1]
        cum = torch.cumsum(d_ * A, dim=1)                  # (b, n, h)
        total = cum[:, -1]
        cumT = cum.transpose(1, 2)
        tril = torch.ones(n, n, dtype=torch.bool).tril()
        decay = torch.exp(torch.where(tril, cumT[..., :, None]
                                      - cumT[..., None, :], float("-inf")))
        M = (torch.einsum("bthn,bshn->bhts", cs, bs) * decay
             * d_.transpose(1, 2)[:, :, None, :])
        y = torch.einsum("bthn,bhnd->bthd", cs, operand(S)) * torch.exp(
            cum)[..., None]
        ys.append(y + torch.einsum("bhts,bshd->bthd", operand(M), xs))
        wx = operand((torch.exp(total[:, None] - cum) * d_)[..., None] * xs)
        S = S * torch.exp(total)[..., None, None] + torch.einsum(
            "bshn,bshd->bhnd", bs, wx)
    y = torch.cat(ys, 1) + D[None, None, :, None] * x.float()
    return y.to(x.dtype), S


def test_hi_lo_split_holds_the_state_tolerance():
    """At a reduced mamba2 shape (state 128, heads of 64, four chunks) with
    chip_smoke.py's input ranges, the mma body's hi + lo operands keep the
    state within its fp32 tolerance (2e-3 + 2e-3 |S|) of the plain
    version, with room to spare; one bf16 rounding of the same operands
    does not."""
    b, l, h, dh, g, ds = 2, 256, 4, 64, 1, 128
    rng = np.random.default_rng(9)
    xbc = torch.from_numpy(rng.standard_normal(
        (b, l, h * dh + 2 * g * ds), np.float32)).bfloat16()
    x = xbc[..., :h * dh].reshape(b, l, h, dh)
    B = xbc[..., h * dh:h * dh + g * ds].reshape(b, l, g, ds)
    C = xbc[..., h * dh + g * ds:].reshape(b, l, g, ds)
    dt = torch.nn.functional.softplus(torch.from_numpy(
        rng.standard_normal((b, l, h), np.float32)) - 1.0)
    A = -torch.linspace(1.0, 16.0, h)
    D = _t(rng.standard_normal(h).astype(np.float32))
    S0 = _t(rng.standard_normal((b, h, ds, dh)).astype(np.float32))
    yp, Sp = sk.ssd_plain(x, dt, A, B, C, D, chunk=128, init_state=S0)

    def share(got, want, atol, rtol):
        return ((got.float() - want.float()).abs()
                / (atol + rtol * want.float().abs())).max().item()

    y2, S2 = _emulate_mma_body(x, dt, A, B, C, D, S0, split=True)
    y1, S1 = _emulate_mma_body(x, dt, A, B, C, D, S0, split=False)
    assert share(S2, Sp, 2e-3, 2e-3) < 0.1
    assert share(S1, Sp, 2e-3, 2e-3) > 1.0
    # y is held at bf16's tolerance (chip_smoke.py TOL): both sides round
    # to bf16, so the split's y is within it and the single rounding's is
    # not.
    assert share(y2, yp, 4e-3, 2 ** -7) < 1.0
    assert share(y1, yp, 4e-3, 2 ** -7) > 1.0


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


@pytest.mark.cuda
@pytest.mark.parametrize("dims", [
    (2, 300, 8, 64, 1, 128),    # mamba2's head and state, ragged length
    (3, 333, 8, 64, 2, 128),    # two groups, state 128
    (2, 130, 8, 64, 2, 64),     # zamba2's state, two groups
    (4, 1, 8, 64, 1, 128),      # a one-row prefill
    (2, 70, 4, 16, 2, 16),      # the SMOKE widths
])
def test_mma_body_matches_plain_on_the_card(card, dims):
    """The tensor-core body (bf16) against the plain version: y within
    bf16's tolerance, the state within fp32's (the hi + lo split), and
    the parked slot's state bitwise its init_state."""
    b, l, h, dh, g, ds = dims
    a = _inputs(10, b, l, h, dh, g, ds)
    args = [_t(a[k]).cuda() for k in ("x", "dt", "A", "B", "C", "D")]
    args[1][1] = 0.0
    for i in (0, 3, 4):
        args[i] = args[i].bfloat16()
    S0 = _t(a["S0"]).cuda()
    assert sk.launch_of(*args, init_state=S0).body == "mma"
    y, S = sk.ssd_cuda(*args, init_state=S0)
    yp, Sp = sk.ssd_plain(*args, init_state=S0)
    assert torch.equal(S[1], S0[1])
    torch.testing.assert_close(y.float(), yp.float(), rtol=2 ** -7,
                               atol=4e-3)
    torch.testing.assert_close(S, Sp, **F32)
