"""The port's sampler held against the JAX package: threefry keys, random
bits and uniforms bitwise equal to ``repro.serve.sampling.sample_keys``
and ``jax.random.bits``/``uniform``, Gumbel noise within 2e-6 (torch's
``log`` and XLA's differ by an ulp on some inputs), ``Sampler`` draws in
all four modes equal to the reference's on the same logits and keys, with
the smallest top-two margin of those draws measured so a near tie would be
reported as one; and the ports of the reference's sampler checks
(``tests/test_sampling.py``)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.serve.sampling import Sampler as JaxSampler  # noqa: E402
from repro.serve.sampling import sample_keys as jax_sample_keys  # noqa: E402
from repro_torch.serve.sampling import (  # noqa: E402
    Sampler,
    gumbel,
    random_bits,
    sample_keys,
    threefry2x32,
    uniform,
)

GUMBEL_ATOL = 2e-6
# Seeds as the engine folds them (Python ints % 2**31), negatives included.
SEEDS = [0, 7, 123456, 2 ** 31 - 1, -1 % 2 ** 31, -123457 % 2 ** 31,
         (2 ** 33 + 5) % 2 ** 31]
TOK_IDX = [0, 1, 2, 31, 1000, 65535, 2 ** 24 + 3]
WIDTHS = [1, 7, 64, 1001, 4096]
TINY = float(jnp.finfo(jnp.float32).tiny)


def _grid():
    """Every (seed, token index) pair of SEEDS x TOK_IDX, as int32."""
    s, i = np.meshgrid(SEEDS, TOK_IDX, indexing="ij")
    return s.ravel().astype(np.int32), i.ravel().astype(np.int32)


def _jax_keys(seeds, idx):
    return jax_sample_keys(jnp.asarray(seeds), jnp.asarray(idx))


def _keys(seeds, idx):
    return sample_keys(torch.from_numpy(seeds), torch.from_numpy(idx))


def test_threefry_known_answer():
    """The Threefry-2x32 (20 rounds) test vectors of Salmon et al. (the
    Random123 known answers, as JAX's own tests pin them)."""
    def run(key, count):
        t = [torch.tensor([v], dtype=torch.int64) for v in (*key, *count)]
        return [int(y) for y in threefry2x32(*t)]

    assert run((0, 0), (0, 0)) == [0x6B200159, 0x99BA4EFE]
    m = 0xFFFFFFFF
    assert run((m, m), (m, m)) == [0x1CB996FC, 0xBB002BE7]
    assert run((0x13198A2E, 0x03707344), (0x243F6A88, 0x85A308D3)) == [
        0xC4923A9C, 0x483DF7A0]


def test_sample_keys_bitwise_equal_jax():
    seeds, idx = _grid()
    want = np.asarray(_jax_keys(seeds, idx)).astype(np.int64)
    got = _keys(seeds, idx)
    assert got.dtype == torch.int64 and got.shape == (len(seeds), 2)
    np.testing.assert_array_equal(got.numpy(), want)


def test_negative_int32_seeds_wrap_as_jax():
    """A raw negative int32 (not folded) wraps to uint32 in both."""
    seeds = np.asarray([-1, -7, -(2 ** 31)], np.int32)
    idx = np.asarray([0, 5, 9], np.int32)
    np.testing.assert_array_equal(
        _keys(seeds, idx).numpy(),
        np.asarray(_jax_keys(seeds, idx)).astype(np.int64))


@pytest.mark.parametrize("width", WIDTHS)
def test_bits_uniform_bitwise_and_gumbel_close(width):
    """``random_bits`` and ``uniform`` bitwise equal to ``jax.random.bits``
    and ``jax.random.uniform(minval=tiny)`` per row key (the odd widths
    included), Gumbel within GUMBEL_ATOL of ``jax.random.gumbel``."""
    seeds, idx = _grid()
    jkeys = _jax_keys(seeds, idx)
    keys = torch.from_numpy(np.asarray(jkeys).astype(np.int64))
    jbits = jax.vmap(lambda k: jax.random.bits(k, (width,), jnp.uint32))(
        jkeys)
    bits = random_bits(keys, width)
    np.testing.assert_array_equal(bits.numpy(),
                                  np.asarray(jbits).astype(np.int64))
    juni = jax.vmap(lambda k: jax.random.uniform(
        k, (width,), jnp.float32, minval=TINY, maxval=1.0))(jkeys)
    uni = uniform(bits)
    assert uni.dtype == torch.float32
    np.testing.assert_array_equal(uni.numpy().view(np.int32),
                                  np.asarray(juni).view(np.int32))
    jg = np.asarray(jax.vmap(lambda k: jax.random.gumbel(
        k, (width,), jnp.float32))(jkeys))
    g = gumbel(keys, width).numpy()
    assert np.abs(g - jg).max() <= GUMBEL_ATOL


MODES = [
    JaxSampler("greedy"),
    JaxSampler("temperature", temperature=0.8),
    JaxSampler("temperature", temperature=1.7),
    JaxSampler("top_k", top_k=1, temperature=1.0),
    JaxSampler("top_k", top_k=5, temperature=0.9),
    JaxSampler("top_k", top_k=64, temperature=1.3),
    JaxSampler("top_p", top_p=0.9, temperature=0.8),
    JaxSampler("top_p", top_p=0.3, temperature=1.0),
    JaxSampler("top_p", top_p=1.0, temperature=1.0),
]


def _draw_cases():
    """Seeded logits (64 rows, vocab 1000 and an odd 257), keys from the
    seed grid at several token indices."""
    rng = np.random.default_rng(17)
    for v in (1000, 257):
        logits = (rng.standard_normal((64, v)) * 3).astype(np.float32)
        seeds = rng.integers(0, 2 ** 31, 64).astype(np.int32)
        idx = rng.integers(0, 4096, 64).astype(np.int32)
        yield logits, seeds, idx


def _port_sampler(s: JaxSampler) -> Sampler:
    return Sampler(s.mode, s.temperature, s.top_k, s.top_p)


@pytest.mark.parametrize("ref", MODES, ids=lambda s: f"{s.mode}"
                         f"-T{s.temperature}-k{s.top_k}-p{s.top_p}")
def test_sampler_equals_reference(ref):
    """The port's draws equal the reference's on the same logits and keys,
    2-D and 3-D (the last position)."""
    port = _port_sampler(ref)
    assert port.needs_keys == ref.needs_keys
    for logits, seeds, idx in _draw_cases():
        jkeys = _jax_keys(seeds, idx) if ref.needs_keys else None
        keys = _keys(seeds, idx) if port.needs_keys else None
        want = np.asarray(ref(jnp.asarray(logits), jkeys))
        got = port(torch.from_numpy(logits), keys)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        got3 = port(torch.from_numpy(np.stack([logits * 0, logits], 1)),
                    keys)
        np.testing.assert_array_equal(got3.numpy(), want)


def test_draws_are_not_near_ties():
    """The draws compared above are decided by more than the Gumbel
    tolerance: the smallest gap between the best and second-best
    perturbed score (reference noise + masked logits) exceeds twice
    GUMBEL_ATOL, so equal draws are not luck and a failing draw there
    would be a real difference, not a tie."""
    margins = []
    for ref in MODES:
        if not ref.needs_keys:
            continue
        for logits, seeds, idx in _draw_cases():
            lf = ref._mask_logits(jnp.asarray(logits)
                                  / max(ref.temperature, 1e-8))
            g = jax.vmap(lambda k, row: jax.random.gumbel(
                k, row.shape, jnp.float32))(_jax_keys(seeds, idx), lf)
            score = np.sort(np.asarray(g + lf), axis=-1)
            top2 = score[:, -2:]
            finite = np.isfinite(top2[:, 0])     # top-k 1 leaves one
            margins.extend((top2[finite, 1] - top2[finite, 0]).tolist())
    assert min(margins) > 2 * GUMBEL_ATOL, min(margins)


# -- the reference's sampler checks (tests/test_sampling.py) ------------------

def _rand_logits(seed, b=8, v=64):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (b, v)).astype(np.float32))


def _row_keys(seed_lo, n, idx=0):
    return sample_keys(torch.arange(seed_lo, seed_lo + n, dtype=torch.int32),
                       torch.full((n,), idx, dtype=torch.int32))


def test_greedy_matches_argmax_and_ignores_keys():
    logits = _rand_logits(0)
    s = Sampler("greedy")
    want = logits.argmax(-1).to(torch.int32)
    assert torch.equal(s(logits), want)
    assert torch.equal(s(logits, _row_keys(0, 8)), want)
    assert torch.equal(s(logits[:, None, :]), want)


def test_temperature_to_zero_converges_to_greedy_exactly():
    logits = _rand_logits(1, b=16, v=128)
    cold = Sampler("temperature", temperature=1e-6)
    want = logits.argmax(-1).to(torch.int32)
    for trial in range(8):
        assert torch.equal(cold(logits, _row_keys(100 * trial, 16)), want)


def test_warm_temperature_actually_samples():
    logits = _rand_logits(2, b=4, v=16)
    warm = Sampler("temperature", temperature=1.0)
    draws = {tuple(warm(logits, _row_keys(t, 4)).tolist())
             for t in range(32)}
    assert len(draws) > 1


def test_top_k_never_leaves_top_k_support():
    logits = _rand_logits(3, b=4, v=32)
    for k in (1, 2, 5):
        s = Sampler("top_k", top_k=k, temperature=1.0)
        allowed = logits.argsort(dim=-1)[:, -k:]
        for trial in range(64):
            got = s(logits, _row_keys(1000 + trial, 4))
            for b in range(4):
                assert got[b] in allowed[b], (k, b, int(got[b]))


def test_top_k_one_is_greedy():
    logits = _rand_logits(4)
    s = Sampler("top_k", top_k=1, temperature=1.0)
    assert torch.equal(s(logits, _row_keys(0, 8)),
                       logits.argmax(-1).to(torch.int32))


def test_top_p_mass_bound_on_crafted_logits():
    """Probabilities [0.5, 0.3, 0.15, 0.05]: the kept set is the smallest
    prefix whose mass reaches top_p (thresholds away from the cumulative
    boundaries)."""
    probs = np.asarray([0.5, 0.3, 0.15, 0.05])
    logits = torch.from_numpy(np.log(probs).astype(np.float32))[None].repeat(
        4, 1)

    def support(p, trials=96):
        s = Sampler("top_p", top_p=p, temperature=1.0)
        out = set()
        for t in range(trials):
            out.update(s(logits, _row_keys(t, 4)).tolist())
        return out

    assert support(0.45) == {0}
    assert support(0.75) == {0, 1}
    assert support(0.9) == {0, 1, 2}
    assert support(1.0) == {0, 1, 2, 3}


def test_top_p_mass_bound_random_logits():
    logits = _rand_logits(5, b=4, v=32)
    p = 0.7
    s = Sampler("top_p", top_p=p, temperature=1.0)
    probs = torch.softmax(logits, -1).numpy()
    order = np.argsort(-probs, axis=-1)
    allowed = []
    for b in range(4):
        csum = np.cumsum(probs[b][order[b]])
        allowed.append(set(order[b][:int(np.searchsorted(csum, p)) + 1]))
    for trial in range(64):
        got = s(logits, _row_keys(5000 + trial, 4))
        for b in range(4):
            assert int(got[b]) in allowed[b]


def test_sample_keys_are_slot_independent():
    k1 = sample_keys(torch.tensor([5, 9], dtype=torch.int32),
                     torch.tensor([3, 3], dtype=torch.int32))
    k2 = sample_keys(torch.tensor([9, 5], dtype=torch.int32),
                     torch.tensor([3, 3], dtype=torch.int32))
    assert torch.equal(k1[0], k2[1]) and torch.equal(k1[1], k2[0])
    k3 = sample_keys(torch.tensor([5], dtype=torch.int32),
                     torch.tensor([4], dtype=torch.int32))
    assert not torch.equal(k1[0], k3[0])


def test_sampler_validation():
    with pytest.raises(ValueError, match="mode"):
        Sampler("beam")
    with pytest.raises(ValueError, match="top_k"):
        Sampler("top_k", top_k=0)
    with pytest.raises(ValueError, match="top_p"):
        Sampler("top_p", top_p=0.0)
    with pytest.raises(ValueError, match="keys"):
        Sampler("temperature")(torch.zeros((1, 4)))


def test_from_config_reads_the_shared_top_k_field():
    """``ModelConfig.top_k`` is the MoE routing width and the sampler's
    top-k at once, as in the reference."""
    from repro_torch.models import get_config

    cfg = get_config("olmoe-1b-7b", smoke=True)
    s = Sampler.from_config(cfg)
    assert (s.mode, s.top_k) == (cfg.sampling, cfg.top_k)
