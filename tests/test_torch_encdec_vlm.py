"""The port's encoder-decoder (whisper) and VLM (llama-3.2-vision) families
held against ``repro.models.whisper`` and ``repro.models.transformer`` on
the same weights: logits on every layout and kernel route, the encoder
states and cross K/V, the reference's ragged-prefill contract, paged ==
contiguous within torch, the engine's greedy streams against the JAX
engine's (``serve_bench.py``'s family set and the speculative matrix),
a restore that recomputes the cross K/V in place, and an integrity sweep
that fingerprints the self pool only.  SMOKE configs, fp32."""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import serve_bench_sets as sets  # noqa: E402

from repro.models import build_model as jax_build  # noqa: E402
from repro.models import get_config as jax_config  # noqa: E402
from repro.models import whisper as jwhisper  # noqa: E402
from repro.serve.engine import Request as JaxRequest  # noqa: E402
from repro.serve.engine import ServeEngine as JaxEngine  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.models import build_model, get_config  # noqa: E402
from repro_torch.models import whisper  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402

torch.set_num_threads(1)
F32 = dict(rtol=2e-3, atol=2e-3)
ARCHS = sets.ENCDEC_VLM
PAGED = dict(cache_layout="paged", kv_page_size=8)


def _source(cfg, b: int, seed: int = 4) -> dict:
    """The per-slot source, seeded numpy: whisper's encoder frames or the
    VLM's vision tokens."""
    rng = np.random.default_rng(seed)
    if cfg.family == "encdec":
        return {"frames": rng.standard_normal(
            (b, cfg.enc_seq, cfg.d_model)).astype(np.float32)}
    return {"vis": rng.standard_normal(
        (b, cfg.n_vis_tokens, cfg.d_model)).astype(np.float32)}


def _jax_src(src):
    return {k: jnp.asarray(v) for k, v in src.items()}


def _torch_src(src):
    return {k: torch.from_numpy(v) for k, v in src.items()}


@functools.lru_cache(maxsize=None)
def _perturbed(arch):
    """JAX init with every leaf moved by seeded noise (the QKV biases and
    norm weights start at 0 and 1), and its bridge into the port."""
    jcfg = jax_config(arch, smoke=True)
    params = jax_build(jcfg).init(jax.random.PRNGKey(0))
    leaves, tree = jax.tree_util.tree_flatten(params)
    rng = np.random.default_rng(0)
    moved = [np.asarray(x, np.float32)
             + 0.1 * rng.standard_normal(np.shape(x)).astype(np.float32)
             for x in leaves]
    jp = jax.tree_util.tree_unflatten(tree, moved)
    return jp, convert.from_jax(jp, get_config(arch, smoke=True), "cpu")


@functools.lru_cache(maxsize=None)
def _weights(arch):
    return sets.weights(arch)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("layout, kernel", [
    ("contiguous", "xla"), ("contiguous", "pallas_paged"),
    ("paged", "xla"), ("paged", "pallas_gather"), ("paged", "pallas_paged"),
])
def test_logits_match_jax(arch, layout, kernel):
    """Ragged prefill then decode steps (one slot parked midway): the
    port's logits within fp32 2e-3 of the reference's, on every route
    (the encoder and cross prefill through the flash kernel's plain
    version with causal=False, the cross decode step through the dense
    decode kernel's)."""
    over = dict(cache_layout=layout, kv_page_size=8, decode_kernel=kernel,
                decode_splits=2)
    jcfg = dataclasses.replace(jax_config(arch, smoke=True), **over)
    tcfg = dataclasses.replace(get_config(arch, smoke=True), **over)
    jp, tp = _perturbed(arch)
    b = 3
    src = _source(jcfg, b)
    jm, tm = jax_build(jcfg), build_model(tcfg, "cpu")
    jcache = jm.init_cache(jp, batch=b, max_len=32, **_jax_src(src))
    tcache = tm.init_cache(tp, batch=b, max_len=32, **_torch_src(src))
    if layout == "paged":
        table = np.array([[5, 0, 9, 2], [1, 3, -1, -1], [11, 7, 4, -1]],
                         np.int32)
        jcache["pages"] = jnp.asarray(table)
        tcache["pages"] = torch.from_numpy(table)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, jcfg.vocab, (b, 16)).astype(np.int32)
    seg = np.array([16, 9, 3], np.int32)
    jl, jcache = jax.jit(jm.prefill)(jp, jcache, jnp.asarray(toks),
                                     seg_lens=jnp.asarray(seg))
    tl, tcache = tm.prefill(tp, tcache, torch.from_numpy(toks),
                            seg_lens=torch.from_numpy(seg))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **F32)
    jdec = jax.jit(jm.decode_step)
    for step in range(3):
        nxt = np.asarray(jl)[:, -1].argmax(-1).astype(np.int32)[:, None]
        act = np.array([1, 1, 0 if step == 1 else 1], np.int32)
        jl, jcache = jdec(jp, jcache, jnp.asarray(nxt),
                          seg_lens=jnp.asarray(act))
        tl, tcache = tm.decode_step(tp, tcache, torch.from_numpy(nxt),
                                    seg_lens=torch.from_numpy(act))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **F32)
    np.testing.assert_array_equal(tcache["lengths"].numpy(),
                                  np.asarray(jcache["lengths"]))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("kernel", ["xla", "pallas_paged"])
def test_source_leaves_match_jax(arch, kernel):
    """The fixed-source leaves against the reference's: whisper's encoder
    states against ``whisper.encode`` and each layer's cross K/V; the
    VLM's projected vision tokens and cross K/V (with the QKV bias
    perturbed into them)."""
    jcfg = jax_config(arch, smoke=True)
    tcfg = dataclasses.replace(get_config(arch, smoke=True),
                               decode_kernel=kernel)
    jp, tp = _perturbed(arch)
    src = _source(jcfg, 2)
    if jcfg.family == "encdec":
        want = jwhisper.encode(jp, jnp.asarray(src["frames"]), jcfg)
        got = whisper.encode(tp, torch.from_numpy(src["frames"]), tcfg)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    jc = jax_build(jcfg).init_cache(jp, batch=2, max_len=16,
                                    **_jax_src(src))
    tc = build_model(tcfg, "cpu").init_cache(tp, batch=2, max_len=16,
                                             **_torch_src(src))
    if jcfg.family == "encdec":
        pairs = [(tc["cross"], jc["cross"])]
    else:
        pairs = [(tc["layers"]["cross"], jc["layers"]["cross"]),
                 ({"vis": tc["vis"]}, {"vis": jc["vis"]})]
    for got, want in pairs:
        for key, leaf in got.items():
            np.testing.assert_allclose(leaf.numpy(), np.asarray(want[key]),
                                       err_msg=f"{arch} {key}", **F32)


@pytest.mark.parametrize("arch", ARCHS)
def test_ragged_prefill_matches_per_row_uniform(arch):
    """The reference's ragged contract (``tests/test_serve.py``) in the
    port on the kernel route: a ragged right-padded prefill and a decode
    step give each slot the logits of its own uniform run, each slot on
    its own source."""
    cfg = dataclasses.replace(get_config(arch, smoke=True),
                              decode_kernel="pallas_paged")
    params = _weights(arch)[1]
    model = build_model(cfg, "cpu")
    src = _torch_src(_source(cfg, 2))
    lens = [5, 8]
    toks = np.random.default_rng(1).integers(
        0, cfg.vocab, (2, 8)).astype(np.int32)
    for b, n in enumerate(lens):
        toks[b, n:] = 0       # right-pad garbage that must never leak in
    cache = model.init_cache(params, batch=2, max_len=16, **src)
    lg, cache = model.prefill(params, cache, torch.from_numpy(toks),
                              seg_lens=torch.tensor(lens, dtype=torch.int32))
    nxt = lg[:, -1].argmax(-1).to(torch.int32)
    lg2, cache = model.decode_step(params, cache, nxt[:, None],
                                   seg_lens=torch.ones(2, dtype=torch.int32))
    for b, n in enumerate(lens):
        c1 = model.init_cache(params, batch=1, max_len=16,
                              **{k: v[b:b + 1] for k, v in src.items()})
        l1, c1 = model.prefill(params, c1, torch.from_numpy(toks[b:b + 1, :n]))
        np.testing.assert_allclose(lg[b, -1].numpy(), l1[0, -1].numpy(),
                                   **F32)
        assert int(l1[0, -1].argmax()) == int(nxt[b])
        l2, _ = model.decode_step(params, c1, nxt[b][None, None])
        np.testing.assert_allclose(lg2[b, -1].numpy(), l2[0, -1].numpy(),
                                   **F32)


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_equals_contiguous_bitwise_in_torch(arch):
    """Within torch the paged cache (gathered view) and the contiguous ring
    give bit-identical logits, as DESIGN.md 5.2 states for the reference."""
    base = get_config(arch, smoke=True)
    params = _weights(arch)[1]
    src = _torch_src(_source(base, 2))
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, 256, (2, 8)).astype(np.int32))
    seg = torch.tensor([8, 5], dtype=torch.int32)
    out = {}
    for layout in ("contiguous", "paged"):
        m = build_model(dataclasses.replace(base, cache_layout=layout,
                                            kv_page_size=8), "cpu")
        c = m.init_cache(params, batch=2, max_len=16, **src)
        if layout == "paged":
            c["pages"] = torch.tensor([[0, 1], [2, 3]], dtype=torch.int32)
        logits, c = m.prefill(params, c, toks, seg_lens=seg)
        step, _ = m.decode_step(params, c, logits.argmax(-1).int(),
                                seg_lens=torch.ones(2, dtype=torch.int32))
        out[layout] = (logits, step)
    assert torch.equal(out["paged"][0], out["contiguous"][0])
    assert torch.equal(out["paged"][1], out["contiguous"][1])


@pytest.mark.parametrize("arch", ARCHS)
def test_family_rows_streams_equal_jax_engine(arch):
    """``serve_bench.py``'s family set (the paged pool smaller than slots x
    max_len) through both engines with the bench's per-slot sources."""
    sets.check_set(_weights(arch), "family_rows", arch)


def _tiled_source(cfg, slots):
    """One source row tiled over the slots (the reference's spec-matrix
    extras): where two runs admit in other orders (plain and speculative,
    uninterrupted and restored), a request's source must not depend on
    its slot."""
    row = _source(cfg, 1)
    return {k: np.tile(v, (slots, 1, 1)) for k, v in row.items()}


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
@pytest.mark.parametrize("arch", ARCHS)
def test_spec_matrix_streams_equal_jax_engine(arch, layout):
    """The reference's speculative matrix (``tests/test_serve.py``) for the
    two families: the port's plain and speculative (cursor rewind) greedy
    streams both equal the JAX engine's plain ones."""
    jp, tp = _weights(arch)
    over = PAGED if layout == "paged" else {}
    kw = {"n_pages": 5} if layout == "paged" else {}
    jcfg = dataclasses.replace(jax_config(arch, smoke=True), **over)
    tcfg = dataclasses.replace(get_config(arch, smoke=True),
                               decode_kernel="pallas_paged", **over)
    extras = _tiled_source(jcfg, 2)
    geometry = dict(batch_slots=2, max_len=32, chunk_size=8, extras=extras,
                    **kw)

    def requests(cls):
        rng = np.random.default_rng(1)
        return [cls(prompt=rng.integers(0, 256, size=n).astype(np.int32),
                    max_new_tokens=m)
                for n, m in ((4, 9), (8, 3), (5, 7), (3, 8))]

    want = JaxEngine(jcfg, jp, **geometry).run(requests(JaxRequest))
    for cfg in (tcfg, dataclasses.replace(tcfg, spec_k=3, spec_ngram=2)):
        eng = ServeEngine(cfg, tp, device="cpu", **geometry)
        got = eng.run(requests(Request))
        assert [r.generated for r in got] == [r.generated for r in want]
    assert eng.policy_report()["speculative"]["rollback"] == "rewind"


def _cross_leaves(eng):
    cross = (eng.cache["cross"] if eng.cfg.family == "encdec"
             else eng.cache["layers"]["cross"])
    return [cross["k"], cross["v"]]


@pytest.mark.parametrize("arch", ARCHS)
def test_restore_recomputes_cross_kv_in_place(arch, tmp_path):
    """A snapshot mid-stream, then ``restore`` on the same engine: the
    cross K/V (and the VLM's ``vis``) are recomputed into the same
    buffers (no ``data_ptr`` moves, bitwise the values made at
    construction), and the restored run gives the uninterrupted streams
    (one source for both slots: a restore re-admits in its own order).
    Prefix sharing, requested, stays off: a prefix's KV depends on its
    slot's source."""
    cfg = dataclasses.replace(get_config(arch, smoke=True), **PAGED,
                              decode_kernel="pallas_paged",
                              prefix_sharing=True)
    extras = _tiled_source(cfg, 2)

    def requests():
        rng = np.random.default_rng(2)
        return [Request(prompt=rng.integers(0, 256, size=n).astype(np.int32),
                        max_new_tokens=m) for n, m in ((6, 6), (10, 8),
                                                       (5, 8))]

    def engine():
        return ServeEngine(cfg, _weights(arch)[1], batch_slots=2, max_len=32,
                           chunk_size=2, device="cpu", extras=extras)

    base = engine()
    assert base.policy_report()["prefix_sharing"] == {"requested": True,
                                                      "enabled": False}
    want = {r.id: r.generated for r in base.run(requests())}
    eng = engine()
    made = [t.clone() for t in _cross_leaves(eng)]
    eng.submit(requests())
    for _ in range(3):
        eng.step()
    spath = str(tmp_path / "mid.json")
    assert eng.snapshot(spath)["in_flight"] >= 1
    ptrs = eng._static_ptrs()
    eng.restore(spath)
    assert eng._static_ptrs() == ptrs
    for got, was in zip(_cross_leaves(eng), made):
        assert torch.equal(got, was)
    eng.drain()
    assert eng.results() == want
    assert eng._static_ptrs() == ptrs


def test_integrity_sweep_fingerprints_the_self_pool_only():
    """With slots = n_pages + 1 and the VLM SMOKE's 8 vision tokens at page
    size 8, each cross K/V leaf (g, slots, 8, hkv, dh) has the pool's
    trailing shape; the sweep still fingerprints exactly the self pool's
    K and V, finds no mismatch, and changes no stream."""
    arch = "llama-3.2-vision-90b"
    base = dataclasses.replace(get_config(arch, smoke=True), **PAGED,
                               decode_kernel="pallas_paged")
    slots, n_pages = 5, 4
    extras = _source(base, slots)
    streams = []
    for integrity in (False, True):
        cfg = dataclasses.replace(base, kv_integrity=integrity)
        eng = ServeEngine(cfg, _weights(arch)[1], batch_slots=slots,
                          max_len=16, chunk_size=2, n_pages=n_pages,
                          device="cpu", extras=extras)
        rng = np.random.default_rng(6)
        reqs = [Request(prompt=rng.integers(0, 256, size=n).astype(np.int32),
                        max_new_tokens=m)
                for n, m in ((9, 4), (3, 5), (8, 6), (4, 3), (10, 5))]
        eng.run(reqs)
        streams.append([r.generated for r in reqs])
    pool = eng.cache["layers"]["self"]
    for leaf in _cross_leaves(eng):
        assert leaf.shape[-4:-2] == (n_pages + 1, base.kv_page_size)
    leaves = eng._pool_leaves()
    assert len(leaves) == 2
    assert leaves[0] is pool["k"] and leaves[1] is pool["v"]
    assert eng.stats["integrity_sweeps"] > 0
    assert eng.stats["corrupted_pages"] == 0
    assert streams[0] == streams[1]
