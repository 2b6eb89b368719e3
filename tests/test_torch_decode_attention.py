"""The port's split-KV decode attention (plain PyTorch versions on the CPU)
held against the JAX package's Pallas kernels (interpret mode) and oracle,
plus the port's own bit-identity and launch-guard contracts."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.decode_attention import decode_attention as jkern  # noqa: E402
from repro.kernels.decode_attention import ops as jops  # noqa: E402
from repro.kernels.decode_attention import ref as jref  # noqa: E402
from repro_torch.kernels.decode_attention import decode_attention as dk  # noqa: E402
from repro_torch.kernels.decode_attention import ops, ref  # noqa: E402
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


def _paged_case(seed, b, hq, hkv, N, psz, P, d, unmapped_tail=True):
    """Numpy twin of test_kernels._paged_case: aliased tables (pages drawn
    with replacement), -1 tails, half the lengths on a page boundary."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hq, d), np.float32)
    kp = rng.standard_normal((N, psz, hkv, d), np.float32)
    vp = rng.standard_normal((N, psz, hkv, d), np.float32)
    pages = rng.integers(0, N, (b, P)).astype(np.int32)
    mapped = rng.integers(1, P + 1, (b,))
    if unmapped_tail:
        pages = np.where(np.arange(P)[None] < mapped[:, None], pages, -1)
    lengths = rng.integers(1, mapped * psz + 1)
    lengths = np.where(np.arange(b) % 2 == 0,
                       np.maximum(lengths // psz, 1) * psz, lengths)
    return q, kp, vp, pages.astype(np.int32), lengths.astype(np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cfg", [
    (2, 8, 2, 512, 64, 128, 1), (2, 8, 2, 512, 64, 128, 4),
    (3, 4, 4, 300, 32, 64, 2), (1, 16, 1, 1024, 128, 256, 8),
])
def test_dense_matches_jax(dtype, cfg):
    b, hq, hkv, s, d, bkv, splits = cfg
    rng = np.random.default_rng(2)
    q, k, v = (rng.standard_normal(sh, np.float32)
               for sh in ((b, hq, d), (b, hkv, s, d), (b, hkv, s, d)))
    lengths = rng.integers(1, s + 1, (b,)).astype(np.int32)
    (jq, tq), (jk, tk), (jv, tv) = (_both(x, dtype) for x in (q, k, v))
    got = ops.decode_attention(tq, tk, tv, torch.from_numpy(lengths),
                               bkv=bkv, splits=splits)
    want = jops.decode_attention(jq, jk, jv, jnp.asarray(lengths), bkv=bkv,
                                 splits=splits)
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])
    np.testing.assert_allclose(
        _np(got), _np(jref.decode_attention(jq, jk, jv, jnp.asarray(lengths))),
        **TOL[dtype])
    assert got.dtype == tq.dtype


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cfg", [
    (2, 8, 2, 12, 16, 4, 64, 1), (2, 8, 2, 12, 16, 4, 64, 4),
    (3, 4, 4, 9, 8, 5, 32, 2), (1, 16, 4, 20, 16, 8, 128, 3),
])
def test_paged_matches_jax_and_equals_gather(dtype, cfg):
    b, hq, hkv, N, psz, P, d, splits = cfg
    q, kp, vp, pages, lengths = _paged_case(7, b, hq, hkv, N, psz, P, d)
    (jq, tq), (jk, tk), (jv, tv) = (_both(x, dtype) for x in (q, kp, vp))
    tpages, tlens = torch.from_numpy(pages), torch.from_numpy(lengths)
    got = ops.paged_decode_attention(tq, tk, tv, tpages, tlens, splits=splits)
    want = jops.paged_decode_attention(jq, jk, jv, jnp.asarray(pages),
                                       jnp.asarray(lengths), splits=splits)
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])
    # Bitwise within torch: paged == dense over the gathered view.
    kd = gather_pages(tk, tpages).transpose(1, 2)
    vd = gather_pages(tv, tpages).transpose(1, 2)
    dense = ops.decode_attention(tq, kd, vd, tlens, bkv=psz, splits=splits)
    assert torch.equal(got, dense)
    np.testing.assert_allclose(
        _np(got), _np(ref.decode_attention(tq, kd, vd, tlens)), **TOL[dtype])


def test_torch_oracle_matches_jax_oracle():
    rng = np.random.default_rng(3)
    q = rng.standard_normal((3, 8, 32), np.float32)
    k = rng.standard_normal((3, 2, 40, 32), np.float32)
    v = rng.standard_normal((3, 2, 40, 32), np.float32)
    lengths = np.array([40, 1, 17], np.int32)
    got = ref.decode_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                               torch.from_numpy(lengths))
    want = jref.decode_attention(q, k, v, jnp.asarray(lengths))
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)


def test_combine_partials_matches_jax_and_zeroes_empty_slots():
    rng = np.random.default_rng(4)
    acc = rng.standard_normal((2, 4, 3, 16), np.float32)
    m = rng.standard_normal((2, 4, 3), np.float32)
    l = rng.uniform(0.5, 2.0, (2, 4, 3)).astype(np.float32)
    # Slot 1 saw no valid position in any split (a parked slot).
    acc[1], m[1], l[1] = 0.0, -1e30, 0.0
    got = dk.combine_partials(*(torch.from_numpy(x) for x in (acc, m, l)))
    want = jkern.combine_partials(acc, m, l)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    assert torch.equal(got[1], torch.zeros_like(got[1]))


def test_aliased_shared_pages():
    """Two slots whose tables alias the same physical pages see identical
    rows: same q gives bit-identical output."""
    rng = np.random.default_rng(8)
    q1 = torch.from_numpy(rng.standard_normal((1, 4, 32), np.float32))
    kp = torch.from_numpy(rng.standard_normal((6, 8, 2, 32), np.float32))
    vp = torch.from_numpy(rng.standard_normal((6, 8, 2, 32), np.float32))
    pages = torch.tensor([[2, 5, 2], [2, 5, 2]], dtype=torch.int32)
    out = ops.paged_decode_attention(torch.cat([q1, q1]), kp, vp, pages,
                                     torch.tensor([20, 20], dtype=torch.int32),
                                     splits=2)
    assert torch.equal(out[0], out[1])


def test_unmapped_tail_contributes_nothing():
    """Poisoning every page unreachable below the cursor (page 0, the -1
    clamp target, stays clean) changes no bit of the output."""
    q, kp, vp, _, _ = _paged_case(9, 2, 4, 2, 8, 8, 4, 32,
                                  unmapped_tail=False)
    q, kp, vp = (torch.from_numpy(x) for x in (q, kp, vp))
    pages = torch.tensor([[3, 1, -1, -1], [6, -1, -1, -1]], dtype=torch.int32)
    lengths = torch.tensor([16, 5], dtype=torch.int32)
    clean = ops.paged_decode_attention(q, kp, vp, pages, lengths)
    reach = torch.zeros(8, dtype=torch.bool)
    reach[[3, 1, 6, 0]] = True
    dirty = ops.paged_decode_attention(
        q, torch.where(reach[:, None, None, None], kp, 1e9),
        torch.where(reach[:, None, None, None], vp, -1e9), pages, lengths)
    assert torch.equal(clean, dirty)


@pytest.mark.parametrize("s", [1, 15, 16, 17, 300, 512, 513, 2048, 4096])
@pytest.mark.parametrize("bkv", [16, 128, 512])
def test_plan_splits_matches_reference(s, bkv):
    assert ops.plan_splits(s, bkv) == jops.plan_splits(s, bkv)


def test_cpu_wrappers_take_the_plain_version():
    dk.reset_counters()
    q, kp, vp, pages, lengths = (torch.from_numpy(x) for x in _paged_case(
        5, 2, 8, 2, 12, 16, 4, 64))
    ops.paged_decode_attention(q, kp, vp, pages, lengths, splits=2)
    ops.decode_attention(q, gather_pages(kp, pages).transpose(1, 2),
                         gather_pages(vp, pages).transpose(1, 2), lengths,
                         bkv=16, splits=2)
    assert (dk.paged_decode_attention_plain.calls,
            dk.decode_attention_plain.calls) == (1, 1)
    assert dk.paged_decode_attention.launches == 0
    assert dk.decode_attention.launches == 0


def _guard_case():
    q, kp, vp, pages, lengths = (torch.from_numpy(x) for x in _paged_case(
        6, 2, 8, 2, 12, 16, 4, 64))
    return dict(q=q, k_pool=kp, v_pool=vp, pages=pages, lengths=lengths)


@pytest.mark.parametrize("change, message", [
    ({}, "CUDA tensors only"),
    ({"q": lambda a: a["q"].double(), "k_pool": lambda a: a["k_pool"].double(),
      "v_pool": lambda a: a["v_pool"].double()}, "not supported"),
    ({"k_pool": lambda a: a["k_pool"].bfloat16()}, "dtypes differ"),
    ({"lengths": lambda a: a["lengths"].long()}, "lengths must be"),
    ({"pages": lambda a: a["pages"].t().contiguous().t()}, "pages must be"),
    ({"q": lambda a: a["q"].transpose(1, 2).contiguous().transpose(1, 2)},
     "stride 1"),
    ({"q": lambda a: torch.zeros(2, 40, 64)}, "group 20 > 16"),
])
def test_cuda_entry_refuses_what_the_kernel_does_not_take(change, message):
    """The CUDA-only entry raises, naming the problem; it never falls back
    to the plain version (CPU tensors are refused too)."""
    args = _guard_case()
    args.update({key: fn(args) for key, fn in change.items()})
    dk.reset_counters()
    with pytest.raises(ValueError, match=message):
        dk.paged_decode_attention_cuda(**args)
    assert dk.paged_decode_attention_plain.calls == 0
    assert dk.paged_decode_attention.launches == 0


def test_dense_cuda_entry_refuses_cpu_tensors():
    rng = np.random.default_rng(1)
    q = torch.from_numpy(rng.standard_normal((1, 4, 32), np.float32))
    k = torch.from_numpy(rng.standard_normal((1, 2, 8, 32), np.float32))
    with pytest.raises(ValueError, match="CUDA tensors only"):
        dk.decode_attention_cuda(q, k, k)
