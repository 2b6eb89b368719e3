"""The request sets of ``benchmarks/serve_bench.py``, built by the bench's
own functions with its seeds and constants, and the check that serves one
set through the JAX engine and the port's engine with equal greedy
streams.  Shared by
``test_torch_serve_bench_sets.py`` (the attention families),
``test_torch_serve_bench_sets_recurrent.py`` (the recurrent ones) and
``test_torch_encdec_vlm.py`` (``ENCDEC_VLM``, on the family set), split
so that each file stays near a minute on one worker.

Each set is served by both engines at the bench row's geometry (slots,
``max_len``, chunk, page, pool and knobs) on a family's fp32 SMOKE config
with the same weights: the JAX engine on its ``xla`` arm, the port on
``pallas_paged`` (the kernels' plain versions on the CPU)."""
import dataclasses
import importlib.util
import pathlib

import jax

from repro.models import build_model as jax_build
from repro.models import get_config as jax_config
from repro.serve.engine import ServeEngine as JaxEngine
from repro_torch import convert
from repro_torch.models import get_config
from repro_torch.serve.engine import Request, ServeEngine

ROOT = pathlib.Path(__file__).resolve().parents[1]


def bench_module():
    """``benchmarks/serve_bench.py``, loaded from its path."""
    spec = importlib.util.spec_from_file_location(
        "serve_bench", ROOT / "benchmarks" / "serve_bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


BENCH = bench_module()
# The fixed-source families: whisper-small is in the bench's family rows,
# the VLM is served beside it on the same set.
ENCDEC_VLM = ("whisper-small", "llama-3.2-vision-90b")
CHAOS = dict(chaos_alloc_fail_p=0.4, chaos_preempt_p=0.25, chaos_seed=0)
# name: (runs (each a function of the JAX config giving the bench's request
# list), engine geometry, config knobs), from the bench row that serves
# the set.
SETS = {
    "serve_rows": ((lambda c: BENCH._requests(c, seed=1),),
                   dict(batch_slots=4, max_len=64, chunk_size=16), {}),
    "paged_rows": ((lambda c: BENCH._mixed_requests(c, seed=1),),
                   dict(batch_slots=4, max_len=128, chunk_size=16,
                        n_pages=12),
                   dict(cache_layout="paged", kv_page_size=16)),
    "prefix_rows": ((lambda c: BENCH._prefix_requests(c, seed=1)[1],),
                    dict(batch_slots=8, max_len=80, chunk_size=8,
                         n_pages=24),
                    dict(cache_layout="paged", kv_page_size=16,
                         prefix_sharing=True)),
    "family_rows": ((lambda c: BENCH._family_requests(c, 1),),
                    dict(batch_slots=2, max_len=32, chunk_size=4, n_pages=5),
                    dict(cache_layout="paged", kv_page_size=8)),
    "chaos_rows": ((BENCH._chaos_requests,),
                   dict(batch_slots=2, max_len=32, chunk_size=4, n_pages=4),
                   dict(cache_layout="paged", kv_page_size=8, **CHAOS)),
    "decode_kernel_rows": ((BENCH._dk_requests,),
                           dict(batch_slots=2, max_len=32, chunk_size=4,
                                n_pages=6),
                           dict(cache_layout="paged", kv_page_size=8,
                                prefix_sharing=True, **CHAOS)),
    "decode_context_rows": (tuple((lambda c, t=t: BENCH._ctx_requests(c, t))
                                  for t in BENCH.DK_CONTEXTS),
                            dict(batch_slots=2, max_len=80, chunk_size=16,
                                 n_pages=10),
                            dict(cache_layout="paged", kv_page_size=16)),
}


def weights(arch):
    """The family's JAX parameters and their bridge into the port."""
    jp = jax_build(jax_config(arch, smoke=True)).init(jax.random.PRNGKey(0))
    return jp, convert.from_jax(jp, get_config(arch, smoke=True), "cpu")


STATS = ("admission_waves", "chunks", "preempted", "preempted_forced",
         "prefix_hits_fresh")


def check_set(weights, name, arch):
    """Serve set ``name`` on ``arch`` through both engines: equal streams,
    every budget spent, equal scheduling counters, no page held."""
    runs, geometry, knobs = SETS[name]
    jp, tp = weights
    jcfg = dataclasses.replace(jax_config(arch, smoke=True),
                               decode_kernel="xla", **knobs)
    tcfg = dataclasses.replace(get_config(arch, smoke=True),
                               decode_kernel="pallas_paged", **knobs)
    # The bench's per-slot sources (encoder frames, vision tokens).
    extras = BENCH._family_extras(jcfg)
    jeng = JaxEngine(jcfg, jp, extras=extras, **geometry)
    eng = ServeEngine(tcfg, tp, device="cpu", extras=extras, **geometry)
    for build in runs:
        # The chaos set's requests carry a sampling seed, which greedy
        # decoding does not read (the port's Request has no such field).
        want = jeng.run(build(jcfg))
        got = eng.run([Request(prompt=r.prompt,
                               max_new_tokens=r.max_new_tokens)
                       for r in build(jcfg)])
        assert [r.generated for r in got] == [r.generated for r in want]
        assert all(len(r.generated) == r.max_new_tokens for r in got)
    stats, jstats = eng.serve_stats(), jeng.serve_stats()
    assert {k: stats[k] for k in STATS} == {k: jstats[k] for k in STATS}
    if eng.paged:
        assert sorted(eng.free_pages) == list(range(eng.n_pages))
