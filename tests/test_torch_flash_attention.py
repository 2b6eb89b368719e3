"""The port's flash attention (plain PyTorch versions on the CPU) held
against the JAX package's Pallas kernel (interpret mode), its oracle and
the reference model's ``_sdpa_naive`` with per-slot offsets; the port's
own paged == dense identity, the prefix-attach case, the CPU dispatch rule
and the CUDA entries' input guards."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import ref as jref  # noqa: E402
from repro.kernels.flash_attention.flash_attention import (  # noqa: E402
    flash_attention as jflash,
)
from repro.models import common as jcm  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention as fk  # noqa: E402
from repro_torch.kernels.flash_attention import ops, ref  # noqa: E402
from repro_torch.models.common import gather_pages  # noqa: E402

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


def _qkv(seed, b, hq, hkv, sq, skv, d):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, hq, sq, d), np.float32),
            rng.standard_normal((b, hkv, skv, d), np.float32),
            rng.standard_normal((b, hkv, skv, d), np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cfg", [
    # (b, hq, hkv, sq, skv, d, causal, q_offset): groups 1/2/3/4, sq != skv,
    # sizes off the 32-row blocks, offsets 0 and > 0.
    (2, 4, 2, 96, 96, 32, True, 0),
    (1, 4, 1, 64, 128, 32, True, 64),
    (2, 4, 4, 50, 50, 16, False, 0),
    (1, 6, 2, 80, 40, 64, False, 0),
    (2, 8, 2, 70, 90, 16, True, 20),
])
def test_plain_and_ref_match_jax_kernel_and_oracle(dtype, cfg):
    b, hq, hkv, sq, skv, d, causal, off = cfg
    q, k, v = _qkv(0, b, hq, hkv, sq, skv, d)
    (jq, tq), (jk, tk), (jv, tv) = (_both(x, dtype) for x in (q, k, v))
    want_kernel = jflash(jq, jk, jv, causal=causal, q_offset=off, bq=32,
                         bkv=32, interpret=True)
    want_ref = jref.attention(jq, jk, jv, causal=causal, q_offset=off)
    got = fk.flash_attention_plain(tq, tk, tv, causal=causal, q_offset=off)
    got_ref = ref.attention(tq, tk, tv, causal=causal, q_offset=off)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    for want in (want_kernel, want_ref):
        np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])
        np.testing.assert_allclose(_np(got_ref), _np(want), **TOL[dtype])


def _ragged(seed, b=4, hq=8, hkv=2, sq=24, t=48, d=16):
    """Per-slot cursors, key lengths and query lengths as the serve path
    gives them: a parked slot (q_len 0), a slot mid-stream, a fresh one."""
    q, k, v = _qkv(seed, b, hq, hkv, sq, t, d)
    off = np.array([0, 17, 30, 5], np.int32)
    q_len = np.array([24, 9, 0, 13], np.int32)
    kv_len = off + q_len
    return q, k, v, off, kv_len, q_len


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_per_slot_offsets_match_jax_sdpa_naive(dtype):
    """Vector q_offset and kv_len against the reference model's
    ``_sdpa_naive`` (its prefill attention) on the valid rows; the padding
    rows (i >= q_len) are exactly zero."""
    q, k, v, off, kv_len, q_len = _ragged(1)
    (jq, tq), (jk, tk), (jv, tv) = (_both(x, dtype) for x in (q, k, v))
    want = jcm._sdpa_naive(jnp.swapaxes(jq, 1, 2), jnp.swapaxes(jk, 1, 2),
                           jnp.swapaxes(jv, 1, 2), True, jnp.asarray(off),
                           kv_len=jnp.asarray(kv_len))
    want = np.swapaxes(_np(want), 1, 2)                     # (b, hq, sq, d)
    got = _np(fk.flash_attention_plain(
        tq, tk, tv, q_offset=torch.from_numpy(off),
        kv_len=torch.from_numpy(kv_len), q_len=torch.from_numpy(q_len)))
    for i, n in enumerate(q_len):
        np.testing.assert_allclose(got[i, :, :n], want[i, :, :n],
                                   **TOL[dtype])
        assert not got[i, :, n:].any()


def _paged_view(seed, k, v, psz=8, spare=3):
    """Scatter dense (b, hkv, t, d) K/V into a shuffled pool: slot 1's
    table aliases slot 0's first two pages (a shared prefix, with equal
    bytes written there), -1 tails past each slot's keys."""
    b, hkv, t, d = k.shape
    P = t // psz
    rng = np.random.default_rng(seed)
    k, v = k.copy(), v.copy()
    k[1, :, :2 * psz], v[1, :, :2 * psz] = k[0, :, :2 * psz], v[0, :, :2 * psz]
    N = b * P + spare
    perm = rng.permutation(N)[:b * P].reshape(b, P).astype(np.int32)
    perm[1, :2] = perm[0, :2]
    kp = rng.standard_normal((N, psz, hkv, d), np.float32)
    vp = rng.standard_normal((N, psz, hkv, d), np.float32)
    for s in range(b):
        for p in range(P):
            kp[perm[s, p]] = k[s, :, p * psz:(p + 1) * psz].transpose(1, 0, 2)
            vp[perm[s, p]] = v[s, :, p * psz:(p + 1) * psz].transpose(1, 0, 2)
    return kp, vp, perm


@pytest.mark.parametrize("causal", [True, False])
def test_paged_equals_dense_bitwise(causal):
    """The paged plain version over the pool equals the dense plain version
    over the gathered view bit for bit, with aliased shared pages and -1
    tails (unmapped pages past every slot's keys contribute nothing, even
    poisoned)."""
    q, k, v, off, kv_len, q_len = _ragged(2)
    kp, vp, pages = _paged_view(3, k, v)
    psz = kp.shape[1]
    mapped = -(-kv_len // psz)
    pages = np.where(np.arange(pages.shape[1])[None] < mapped[:, None],
                     pages, -1).astype(np.int32)
    t = {n: torch.from_numpy(x) for n, x in dict(
        q=q, kp=kp, vp=vp, pages=pages, off=off, kv_len=kv_len,
        q_len=q_len).items()}
    kw = dict(causal=causal, q_offset=t["off"], kv_len=t["kv_len"],
              q_len=t["q_len"])
    paged = ops.paged_flash_attention(t["q"], t["kp"], t["vp"], t["pages"],
                                      **kw)
    dense = ops.flash_attention(
        t["q"], gather_pages(t["kp"], t["pages"]).transpose(1, 2),
        gather_pages(t["vp"], t["pages"]).transpose(1, 2), **kw)
    assert torch.equal(paged, dense)
    reach = np.zeros(kp.shape[0], bool)
    reach[pages[pages >= 0]] = True
    poisoned = ops.paged_flash_attention(
        t["q"], torch.where(torch.from_numpy(reach)[:, None, None, None],
                            t["kp"], 1e30),
        torch.where(torch.from_numpy(reach)[:, None, None, None], t["vp"],
                    float("nan")), t["pages"], **kw)
    assert torch.equal(paged, poisoned)


def test_prefix_attach_matches_whole_prompt_rows():
    """A suffix prefilled at ``q_offset`` = the shared prefix's length,
    reading prefix pages another slot wrote, gives the suffix rows of the
    attention over the whole prompt."""
    b, hq, hkv, d, psz = 2, 4, 2, 16, 8
    pre, suf = 16, 12
    q, k, v = _qkv(4, 1, hq, hkv, pre + suf, 32, d)
    k[:, :, pre + suf:] = 0.0
    v[:, :, pre + suf:] = 0.0
    kk, vv = np.concatenate([k, k]), np.concatenate([v, v])
    kp, vp, pages = _paged_view(5, kk, vv, psz=psz)   # slot 1 aliases pages
    pages = torch.from_numpy(pages)
    kp, vp = torch.from_numpy(kp), torch.from_numpy(vp)
    whole = ops.paged_flash_attention(
        torch.from_numpy(q), kp, vp, pages[:1],
        kv_len=torch.tensor([pre + suf], dtype=torch.int32))
    attached = ops.paged_flash_attention(
        torch.from_numpy(q[:, :, pre:]), kp, vp, pages[1:],
        q_offset=torch.tensor([pre], dtype=torch.int32),
        kv_len=torch.tensor([pre + suf], dtype=torch.int32))
    np.testing.assert_allclose(attached.numpy(), whole[:, :, pre:].numpy(),
                               rtol=1e-6, atol=1e-6)


def test_cpu_wrappers_take_the_plain_version():
    q, k, v, off, kv_len, q_len = (torch.from_numpy(x) for x in _ragged(6))
    kp, vp, pages = (torch.from_numpy(x)
                     for x in _paged_view(7, k.numpy(), v.numpy()))
    fk.reset_counters()
    ops.flash_attention(q, k, v, q_offset=off, kv_len=kv_len, q_len=q_len)
    ops.paged_flash_attention(q, kp, vp, pages, q_offset=3)
    assert (fk.flash_attention_plain.calls,
            fk.paged_flash_attention_plain.calls) == (1, 1)
    assert fk.flash_attention.launches == 0
    assert fk.paged_flash_attention.launches == 0


def _guard_case():
    q, k, v, off, kv_len, q_len = (torch.from_numpy(x) for x in _ragged(8))
    kp, vp, pages = (torch.from_numpy(x)
                     for x in _paged_view(9, k.numpy(), v.numpy()))
    return dict(q=q, k_pool=kp, v_pool=vp, pages=pages)


@pytest.mark.parametrize("change, message", [
    ({}, "CUDA tensors only"),
    ({"q": lambda a: a["q"].double(), "k_pool": lambda a: a["k_pool"].double(),
      "v_pool": lambda a: a["v_pool"].double()}, "not supported"),
    ({"k_pool": lambda a: a["k_pool"].bfloat16()}, "dtypes differ"),
    ({"v_pool": lambda a: a["v_pool"][:-1]}, "share shape and strides"),
    ({"pages": lambda a: a["pages"].long()}, "pages must be"),
    ({"q": lambda a: a["q"].transpose(2, 3).contiguous().transpose(2, 3)},
     "stride 1"),
    ({"q": lambda a: torch.zeros(4, 8, 24, 320),
      "k_pool": lambda a: torch.zeros(27, 8, 2, 320),
      "v_pool": lambda a: torch.zeros(27, 8, 2, 320)}, "at most 256"),
    ({"q": lambda a: a["q"][:, :, :, 0]}, "4-D"),
])
def test_cuda_entry_refuses_what_the_kernel_does_not_take(change, message):
    """The CUDA-only entries raise, naming the problem; they never fall
    back to the plain version (CPU tensors are refused too)."""
    args = _guard_case()
    args.update({key: fn(args) for key, fn in change.items()})
    fk.reset_counters()
    with pytest.raises(ValueError, match=message):
        fk.paged_flash_attention_cuda(**args)
    assert fk.paged_flash_attention_plain.calls == 0
    assert fk.paged_flash_attention.launches == 0


def test_dense_cuda_entry_refuses_cpu_tensors():
    q, k, v = (torch.from_numpy(x) for x in _qkv(10, 1, 4, 2, 8, 8, 16))
    with pytest.raises(ValueError, match="CUDA tensors only"):
        fk.flash_attention_cuda(q, k, v)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the flash kernel has no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 80, 128])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_matches_plain_on_the_card(card, dtype, d):
    """Both device bodies (bf16: the tensor cores, at the head dim's own
    width; fp32: the CUDA cores) against the plain version on the card at
    the serve path's ragged shape (per-slot offsets, a parked slot), paged
    == dense bitwise, and the full causal case."""
    q, k, v, off, kv_len, q_len = _ragged(11, d=d)
    kp, vp, pages = _paged_view(12, k, v)
    tdt = DTYPES[dtype][1]
    t = {n: torch.from_numpy(x).cuda() for n, x in dict(
        off=off, kv_len=kv_len, q_len=q_len, pages=pages).items()}
    tq, tk, tv, tkp, tvp = (torch.from_numpy(x).to(tdt).cuda()
                            for x in (q, k, v, kp, vp))
    kw = dict(q_offset=t["off"], kv_len=t["kv_len"], q_len=t["q_len"])
    paged = fk.paged_flash_attention_cuda(tq, tkp, tvp, t["pages"], **kw)
    dense = fk.flash_attention_cuda(
        tq, gather_pages(tkp, t["pages"]).transpose(1, 2),
        gather_pages(tvp, t["pages"]).transpose(1, 2), **kw)
    want = fk.paged_flash_attention_plain(tq, tkp, tvp, t["pages"], **kw)
    full = fk.flash_attention_cuda(tq, tk, tv, causal=True)
    full_want = fk.flash_attention_plain(tq, tk, tv, causal=True)
    torch.cuda.synchronize()
    assert fk.body(tq, tk, tv) == ("mma" if dtype == "bfloat16"
                                   else "cuda_cores")
    assert torch.equal(paged, dense)
    atol, rtol = {"float32": (2e-3, 2e-3), "bfloat16": (4e-3, 2 ** -7)}[dtype]
    for got, ref_ in ((paged, want), (full, full_want)):
        err = (got.float() - ref_.float()).abs()
        assert bool((err <= atol + rtol * ref_.float().abs()).all())
