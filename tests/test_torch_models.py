"""The port's dense decoder held against ``repro.models`` on the same
weights: KV scatter/gather exactly, attention and logits within fp32
tolerance, through the weight bridge."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import build_model as jax_build  # noqa: E402
from repro.models import common as jcm  # noqa: E402
from repro.models import get_config as jax_config  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.models import build_model, get_config  # noqa: E402
from repro_torch.models import common as cm  # noqa: E402

torch.set_num_threads(1)
F32 = dict(rtol=2e-3, atol=2e-3)


def _kv_case(seed, b=3, s=5, N=7, psz=4, P=3, h=2, d=3):
    """Lengths near the end of the mapped range (overflow), -1 pages,
    invalid rows past seg_lens, and a parked slot (seg 0)."""
    rng = np.random.default_rng(seed)
    pool = rng.standard_normal((N, psz, h, d)).astype(np.float32)
    new = rng.standard_normal((b, s, h, d)).astype(np.float32)
    pages = np.array([[4, 0, -1], [2, 6, 5], [1, -1, -1]], np.int32)
    lengths = np.array([3, 9, 0], np.int32)
    seg = np.array([5, 4, 0], np.int32)
    return pool, new, pages, lengths, seg


@pytest.mark.parametrize("use_seg", [True, False])
def test_append_kv_paged_equals_jax(use_seg):
    pool, new, pages, lengths, seg = _kv_case(0)
    seg_j = jnp.asarray(seg) if use_seg else None
    want = jcm.append_kv_paged(jnp.asarray(pool), jnp.asarray(new),
                               jnp.asarray(lengths), seg_j, jnp.asarray(pages))
    buf = torch.from_numpy(np.concatenate([pool, np.zeros_like(pool[:1])]))
    cm.append_kv_paged(buf, torch.from_numpy(new), torch.from_numpy(lengths),
                       torch.from_numpy(seg) if use_seg else None,
                       torch.from_numpy(pages))
    np.testing.assert_array_equal(buf[:-1].numpy(), np.asarray(want))


@pytest.mark.parametrize("use_seg", [True, False])
def test_append_kv_equals_jax(use_seg):
    rng = np.random.default_rng(1)
    ring = rng.standard_normal((3, 10, 2, 3)).astype(np.float32)
    new = rng.standard_normal((3, 5, 2, 3)).astype(np.float32)
    lengths = np.array([0, 7, 4], np.int32)
    seg = np.array([5, 5, 0], np.int32)
    want = jcm.append_kv(jnp.asarray(ring), jnp.asarray(new),
                         jnp.asarray(lengths),
                         jnp.asarray(seg) if use_seg else None)
    buf = torch.from_numpy(
        np.concatenate([ring, np.zeros_like(ring[:, :1])], axis=1))
    cm.append_kv(buf, torch.from_numpy(new), torch.from_numpy(lengths),
                 torch.from_numpy(seg) if use_seg else None)
    np.testing.assert_array_equal(buf[:, :-1].numpy(), np.asarray(want))


def test_gather_pages_equals_jax():
    pool, _, pages, _, _ = _kv_case(2)
    want = jcm.gather_pages(jnp.asarray(pool), jnp.asarray(pages))
    got = cm.gather_pages(torch.from_numpy(pool), torch.from_numpy(pages))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("causal_off", [0, "ragged"])
def test_sdpa_paths_match_jax(causal_off):
    """_sdpa_naive and _sdpa_chunked (small blocks, so the loops run) with
    causal per-slot offsets and kv_len masks."""
    rng = np.random.default_rng(3)
    b, s, t, hq, hkv, dh = 3, 11, 29, 4, 2, 8
    q = rng.standard_normal((b, s, hq, dh)).astype(np.float32)
    k = rng.standard_normal((b, t, hkv, dh)).astype(np.float32)
    v = rng.standard_normal((b, t, hkv, dh)).astype(np.float32)
    off = 0 if causal_off == 0 else np.array([0, 5, 18], np.int32)
    kv_len = np.array([11, 16, 29], np.int32)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    toff = off if causal_off == 0 else torch.from_numpy(off)
    want = jcm._sdpa_naive(q, k, v, True, off, jnp.asarray(kv_len))
    got = cm._sdpa_naive(tq, tk, tv, True, toff, torch.from_numpy(kv_len))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    want_c = jcm._sdpa_chunked(q, k, v, True, off, jnp.asarray(kv_len),
                               chunk=8, q_block=4)
    got_c = cm._sdpa_chunked(tq, tk, tv, True, toff,
                             torch.from_numpy(kv_len), chunk=8, q_block=4)
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), **F32)
    np.testing.assert_allclose(got_c.numpy(), got.numpy(), **F32)


def test_rope_and_layer_norm_match_jax():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    pos = np.array([[0, 1, 2, 3, 4], [7, 8, 9, 10, 11]], np.int32)
    np.testing.assert_allclose(
        cm.rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6).numpy(),
        np.asarray(jcm.rope(x, pos, 1e6)), rtol=1e-5, atol=1e-5)
    cfg = dataclasses.replace(get_config("yi-9b", smoke=True),
                              norm_kind="layer")
    h = rng.standard_normal((2, 5, cfg.d_model)).astype(np.float32)
    p = {"w": rng.standard_normal(cfg.d_model).astype(np.float32),
         "b": rng.standard_normal(cfg.d_model).astype(np.float32)}
    got = cm.apply_norm({k: torch.from_numpy(a) for k, a in p.items()},
                        torch.from_numpy(h), cfg)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jcm.apply_norm(p, h, cfg)),
                               rtol=1e-5, atol=1e-5)


def _perturbed_params(jcfg):
    """JAX init with every leaf moved by seeded noise: attn_init zeroes the
    QKV biases and norm_init sets the norm weights to one, so an unperturbed
    bridge would not test them."""
    params = jax_build(jcfg).init(jax.random.PRNGKey(0))
    leaves, tree = jax.tree_util.tree_flatten(params)
    rng = np.random.default_rng(0)
    moved = [np.asarray(x, np.float32)
             + 0.1 * rng.standard_normal(np.shape(x)).astype(np.float32)
             for x in leaves]
    return jax.tree_util.tree_unflatten(tree, moved)


@pytest.mark.parametrize("arch", ["qwen2.5-32b", "yi-9b"])
@pytest.mark.parametrize("layout, kernel", [
    ("contiguous", "xla"), ("contiguous", "pallas_paged"),
    ("paged", "xla"), ("paged", "pallas_gather"), ("paged", "pallas_paged"),
])
def test_logits_match_jax(arch, layout, kernel):
    """Ragged prefill then decode steps (one slot parked midway): the
    port's logits within fp32 2e-3 of repro.models.transformer's."""
    over = dict(cache_layout=layout, kv_page_size=8, decode_kernel=kernel,
                decode_splits=2)
    jcfg = dataclasses.replace(jax_config(arch, smoke=True), **over)
    tcfg = dataclasses.replace(get_config(arch, smoke=True), **over)
    jparams = _perturbed_params(jcfg)
    tparams = convert.from_jax(jparams, tcfg, "cpu")
    b, max_len = 3, 32
    jm, tm = jax_build(jcfg), build_model(tcfg, "cpu")
    jcache = jm.init_cache(jparams, batch=b, max_len=max_len)
    tcache = tm.init_cache(tparams, batch=b, max_len=max_len)
    if layout == "paged":
        table = np.array([[5, 0, 9, 2], [1, 3, -1, -1], [11, 7, 4, -1]],
                         np.int32)
        jcache["pages"] = jnp.asarray(table)
        tcache["pages"] = torch.from_numpy(table)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, jcfg.vocab, (b, 16)).astype(np.int32)
    seg = np.array([16, 9, 3], np.int32)
    jpre, tpre = jax.jit(jm.prefill), tm.prefill
    jl, jcache = jpre(jparams, jcache, jnp.asarray(toks),
                      seg_lens=jnp.asarray(seg))
    tl, tcache = tpre(tparams, tcache, torch.from_numpy(toks),
                      seg_lens=torch.from_numpy(seg))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **F32)
    jdec = jax.jit(jm.decode_step)
    for step in range(3):
        nxt = np.asarray(jl)[:, -1].argmax(-1).astype(np.int32)[:, None]
        act = np.array([1, 1, 0 if step == 1 else 1], np.int32)
        jl, jcache = jdec(jparams, jcache, jnp.asarray(nxt),
                          seg_lens=jnp.asarray(act))
        tl, tcache = tm.decode_step(tparams, tcache, torch.from_numpy(nxt),
                                    seg_lens=torch.from_numpy(act))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **F32)
    np.testing.assert_array_equal(tcache["lengths"].numpy(),
                                  np.asarray(jcache["lengths"]))


def test_all_logits_and_uniform_prefill_match_jax():
    jcfg = jax_config("yi-9b", smoke=True)
    tcfg = get_config("yi-9b", smoke=True)
    jparams = _perturbed_params(jcfg)
    tparams = convert.from_jax(jparams, tcfg, "cpu")
    jm, tm = jax_build(jcfg), build_model(tcfg, "cpu")
    toks = np.random.default_rng(2).integers(0, 256, (2, 6)).astype(np.int32)
    jl, _ = jm.prefill(jparams, jm.init_cache(jparams, batch=2, max_len=16),
                       jnp.asarray(toks), all_logits=True)
    tl, tc = tm.prefill(tparams, tm.init_cache(tparams, batch=2, max_len=16),
                        torch.from_numpy(toks), all_logits=True)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **F32)
    assert tc["lengths"].tolist() == [6, 6]


def test_paged_equals_contiguous_bitwise_in_torch():
    """Within torch the paged cache (gathered view) and the contiguous ring
    give bit-identical logits, as DESIGN.md 5.2 states for the reference."""
    base = get_config("qwen2.5-32b", smoke=True)
    gen = torch.Generator().manual_seed(0)
    params = convert.init(base, gen, "cpu")
    toks = torch.from_numpy(
        np.random.default_rng(3).integers(0, 256, (2, 8)).astype(np.int32))
    seg = torch.tensor([8, 5], dtype=torch.int32)
    out = {}
    for layout in ("contiguous", "paged"):
        m = build_model(dataclasses.replace(base, cache_layout=layout,
                                            kv_page_size=8), "cpu")
        c = m.init_cache(params, batch=2, max_len=16)
        if layout == "paged":
            c["pages"] = torch.tensor([[0, 1], [2, 3]], dtype=torch.int32)
        logits, c = m.prefill(params, c, toks, seg_lens=seg)
        step, _ = m.decode_step(params, c, logits.argmax(-1).int(),
                                seg_lens=torch.tensor([1, 1],
                                                      dtype=torch.int32))
        out[layout] = (logits, step)
    assert torch.equal(out["paged"][0], out["contiguous"][0])
    assert torch.equal(out["paged"][1], out["contiguous"][1])


def test_init_draws_reference_distributions():
    cfg = get_config("qwen2.5-32b", smoke=True)
    p = convert.init(cfg, torch.Generator().manual_seed(0), "cpu")
    layer = p["layers"][0]
    assert len(p["layers"]) == cfg.n_layers
    assert tuple(layer["attn"]["wq"].shape) == (64, 4, 16)
    assert tuple(layer["attn"]["wo"].shape) == (4, 16, 64)
    assert torch.equal(layer["attn"]["bq"], torch.zeros(4, 16))
    assert torch.equal(layer["ln1"]["w"], torch.ones(64))
    assert abs(p["embed"]["tok"].std().item() - 0.02) < 2e-3
    assert abs(layer["mlp"]["wd"].std().item() - 192 ** -0.5) < 0.01


def test_unported_family_raises():
    cfg = dataclasses.replace(get_config("yi-9b", smoke=True),
                              family="encdec")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_model(cfg, "cpu")
    with pytest.raises(NotImplementedError, match="'encdec'"):
        convert.from_jax({"layers": {}}, cfg, "cpu")
