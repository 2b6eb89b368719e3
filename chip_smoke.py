#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA H100.

    python3 chip_smoke.py [--seed N]

Phases, each printing one JSON line; any failure raises and exits non-zero:

1. card and build: the card's name and power limit, the CUDA version, and
   the time to build the split-KV decode kernel from
   src/repro_torch/kernels/decode_attention/csrc/decode_attention.cu with
   nvcc for sm_90a (into build/repro_torch/);
2. kernels against their plain PyTorch versions on the card, at yi-9b's
   decode shapes (hq 32, hkv 4, d 128, page 16, 16 slots, contexts 512 and
   2048, splits 1 and planned, bf16 and fp32): tolerance (TOL) fp32 2e-3,
   bf16 4e-3 + 2^-7 |want|, paged == dense bitwise, the reference's
   property cases, and
   device timings (CUDA graph replay, CUDA events) of kernel, plain
   version, SDPA over the gathered view (the library yardstick) and the
   memory bound;
3. serve yi-9b at its published config (48 layers, bf16, random weights
   from a seed) through ServeEngine over a paged pool: 48 greedy requests,
   launch counts checked, then the same requests under pallas_gather with
   bitwise-equal token streams;
   followed by a torch.profiler trace of one decode chunk (device busy
   time, idle share, kernels by device time);
4. the kernel path against the plain path end to end: yi-9b's width at 4
   layers in fp32, prefill plus decode steps, logits within 2e-3.

Then the kernels' summary line, the card's line from nvidia-smi, and the
result line ``{"ok": true, "device": {...}}`` last.  Without a CUDA card it
exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory rate
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}   # dense peaks
# (atol, rtol): a check passes where |got - want| <= atol + rtol * |want|.
# fp32 is the reference's 2e-3 (tests/test_kernels.py).  bf16 is held
# tighter than the reference's 3e-2, which covers JAX's rounding across
# frameworks: here both sides read the same bf16 inputs and accumulate in
# fp32, so they differ by summation order and at most one bf16 rounding
# step of the output (rtol 2^-7); atol 4e-3 is about 4x the largest error
# measured at the main shape (9.8e-4).
TOL = {torch.float32: (2e-3, 2e-3), torch.bfloat16: (4e-3, 2 ** -7)}
HQ, HKV, D, PSZ, SLOTS, MAX_LEN = 32, 4, 128, 16, 16, 2048
KERNEL_SOURCE = "src/repro_torch/kernels/decode_attention/csrc/decode_attention.cu"
TPU_SITES = {
    "paged_decode_attention":
        "src/repro/kernels/decode_attention/decode_attention.py:274",
    "decode_attention":
        "src/repro/kernels/decode_attention/decode_attention.py:106",
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


def check_close(name, got, want, dtype) -> float:
    """max |got - want|; raises unless |got - want| <= atol + rtol * |want|
    everywhere (TOL)."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    atol, rtol = TOL[dtype]
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: non-finite kernel output")
    if bool((err > atol + rtol * want.abs()).any()):
        raise AssertionError(f"{name}: max abs err {err.max().item():.3e} "
                             f"beyond tolerance atol {atol}, rtol {rtol}")
    return err.max().item()


def check_equal(name, a, b) -> None:
    if not torch.equal(a, b):
        raise AssertionError(f"{name}: not bitwise equal (max diff "
                             f"{(a.float() - b.float()).abs().max().item()})")


_flush = None


def time_ms(fn, reps: int = 25, warm: int = 3) -> float:
    """Median device time of one call of ``fn``: the call is captured in a
    CUDA graph and each replay timed with CUDA events, so the host's
    enqueue cost is not counted.  The L2 cache is flushed before each
    replay (the serve loop reaches each layer's pool cold)."""
    global _flush
    if _flush is None:
        _flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warm):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    times = []
    for _ in range(reps):
        _flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# ---------------------------------------------------------------------------
# Phase 2: kernels
# ---------------------------------------------------------------------------

def _pool_case(gen, dtype, lengths, n_table, n_pages):
    """Random q and pools, and page tables mapping distinct pages (a
    seeded permutation) up to each slot's length, -1 beyond."""
    b = lengths.shape[0]
    q = torch.randn(b, HQ, D, generator=gen, device="cuda").to(dtype)
    kp = torch.randn(n_pages, PSZ, HKV, D, generator=gen, device="cuda").to(dtype)
    vp = torch.randn(n_pages, PSZ, HKV, D, generator=gen, device="cuda").to(dtype)
    perm = torch.randperm(n_pages, generator=gen, device="cuda")
    pages = perm[: b * n_table].reshape(b, n_table).to(torch.int32)
    mapped = (lengths.long() + PSZ - 1) // PSZ
    cols = torch.arange(n_table, device="cuda")[None, :]
    pages = torch.where(cols < mapped[:, None], pages, -1).contiguous()
    return q, kp, vp, pages


def _bound(dtype, lengths, b, n_mapped):
    """Least time for one call: bytes each input read once and the output
    written once, against operations at the input type's peak."""
    esize = torch.empty((), dtype=dtype).element_size()
    tokens = int(lengths.sum())
    nbytes = (2 * tokens * HKV * D * esize          # valid K and V
              + b * HQ * D * esize * 2              # q in, out written
              + 4 * (n_mapped + b))                 # page entries, lengths
    ops = 4 * tokens * HQ * D                       # QK^T and PV
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def phase_kernels(gpu: str, seed: int) -> dict:
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention import decode_attention as dk
    from repro_torch.kernels.decode_attention import ref
    from repro_torch.kernels.decode_attention.ops import plan_splits
    from repro_torch.models.common import gather_pages

    gen = torch.Generator(device="cuda").manual_seed(seed)
    n_table = MAX_LEN // PSZ
    n_pages = SLOTS * n_table
    planned = plan_splits(n_table * PSZ, PSZ)
    rows, errs = [], {"paged_decode_attention": 0.0, "decode_attention": 0.0}
    main = {}
    for dtype in (torch.bfloat16, torch.float32):
        for ctx in (512, 2048):
            lengths = torch.full((SLOTS,), ctx, dtype=torch.int32,
                                 device="cuda")
            q, kp, vp, pages = _pool_case(gen, dtype, lengths, n_table,
                                          n_pages)
            kd = gather_pages(kp, pages).transpose(1, 2)
            vd = gather_pages(vp, pages).transpose(1, 2)
            for splits in sorted({1, planned}):
                def paged():
                    return dk.paged_decode_attention_cuda(
                        q, kp, vp, pages, lengths, splits=splits)

                def dense():
                    return dk.decode_attention_cuda(
                        q, kd, vd, lengths, bkv=PSZ, splits=splits)

                def plain():
                    return dk.paged_decode_attention_plain(
                        q, kp, vp, pages, lengths, splits=splits)

                def dense_plain():
                    return dk.decode_attention_plain(
                        q, kd, vd, lengths, bkv=PSZ, splits=splits)

                out_p, out_d, want = paged(), dense(), plain()
                torch.cuda.synchronize()
                e_p = check_close(f"paged {dtype} ctx{ctx} s{splits}",
                                  out_p, want, dtype)
                e_d = check_close(f"dense {dtype} ctx{ctx} s{splits}", out_d,
                                  dense_plain(), dtype)
                check_equal(f"paged == dense {dtype} ctx{ctx} s{splits}",
                            out_p, out_d)
                check_close(f"oracle {dtype} ctx{ctx} s{splits}", out_p,
                            ref.decode_attention(q, kd, vd, lengths), dtype)
                errs["paged_decode_attention"] = max(
                    errs["paged_decode_attention"], e_p)
                errs["decode_attention"] = max(errs["decode_attention"], e_d)
                kdc, vdc = kd.contiguous(), vd.contiguous()
                mask = (torch.arange(kd.shape[2], device="cuda")[None, :]
                        < lengths[:, None])[:, None, None, :]

                def library():
                    return F.scaled_dot_product_attention(
                        q[:, :, None], kdc, vdc, attn_mask=mask,
                        enable_gqa=True)

                lib_err = (library()[:, :, 0].float()
                           - want.float()).abs().max().item()
                bound_ms, bound_by = _bound(
                    dtype, lengths, SLOTS, int((pages >= 0).sum()))
                row = {
                    "dtype": str(dtype).removeprefix("torch."), "ctx": ctx,
                    "splits": splits, "paged_ms": time_ms(paged),
                    "dense_ms": time_ms(dense), "plain_ms": time_ms(plain),
                    "dense_plain_ms": time_ms(dense_plain),
                    "library_ms": time_ms(library), "bound_ms": bound_ms,
                    "bound_by": bound_by, "paged_err": e_p, "dense_err": e_d,
                    "library_err": lib_err,
                }
                rows.append(row)
                if dtype == torch.bfloat16 and ctx == 2048 and splits == planned:
                    main = row
    # Contiguous-ring arm: the dense kernel over a (b, S, hkv, d) ring by
    # strides, bkv 512 (no transpose copy).
    ring = torch.randn(2, SLOTS, MAX_LEN + 1, HKV, D, generator=gen,
                       device="cuda").to(torch.bfloat16)
    ring_k, ring_v = ring[0, :, :-1], ring[1, :, :-1]
    lengths = torch.randint(1, MAX_LEN + 1, (SLOTS,), generator=gen,
                            device="cuda", dtype=torch.int32)
    q = torch.randn(SLOTS, HQ, D, generator=gen,
                    device="cuda").to(torch.bfloat16)
    splits = plan_splits(MAX_LEN, 512)
    e_ring = check_close(
        "ring", dk.decode_attention_cuda(
            q, ring_k.transpose(1, 2), ring_v.transpose(1, 2), lengths,
            bkv=512, splits=splits),
        dk.decode_attention_plain(
            q, ring_k.transpose(1, 2), ring_v.transpose(1, 2), lengths,
            bkv=512, splits=splits), torch.bfloat16)
    errs["decode_attention"] = max(errs["decode_attention"], e_ring)
    props = property_cases(gen)
    torch.cuda.synchronize()
    emit({"phase": "kernels", "gpu": gpu, "rows": rows,
          "ring_err": e_ring, "property_cases": props,
          "tol_atol_rtol": {str(t).removeprefix("torch."): v
                            for t, v in TOL.items()}})
    return {"main": main, "errs": errs}


def property_cases(gen) -> list[str]:
    """The reference's paged-kernel property cases (tests/test_kernels.py)
    on the card, fp32, at yi-9b's head shapes."""
    from repro_torch.kernels.decode_attention import decode_attention as dk
    from repro_torch.kernels.decode_attention import ref
    from repro_torch.models.common import gather_pages

    done = []
    # Ragged lengths with -1 tails and exact page-boundary hits, aliased
    # tables (pages drawn with replacement), several split counts.
    b, N, P = 6, 24, 10
    q = torch.randn(b, HQ, D, generator=gen, device="cuda")
    kp = torch.randn(N, PSZ, HKV, D, generator=gen, device="cuda")
    vp = torch.randn(N, PSZ, HKV, D, generator=gen, device="cuda")
    pages = torch.randint(0, N, (b, P), generator=gen, device="cuda",
                          dtype=torch.int32)
    mapped = torch.randint(1, P + 1, (b,), generator=gen, device="cuda")
    pages = torch.where(torch.arange(P, device="cuda")[None] < mapped[:, None],
                        pages, -1).to(torch.int32).contiguous()
    lengths = (torch.rand(b, generator=gen, device="cuda")
               * (mapped * PSZ)).long() + 1
    lengths = torch.where(torch.arange(b, device="cuda") % 2 == 0,
                          (lengths // PSZ).clamp_min(1) * PSZ, lengths)
    lengths = lengths.to(torch.int32)
    kd = gather_pages(kp, pages).transpose(1, 2)
    vd = gather_pages(vp, pages).transpose(1, 2)
    for splits in (1, 3, 4, P):
        got = dk.paged_decode_attention_cuda(q, kp, vp, pages, lengths,
                                             splits=splits)
        check_equal(f"ragged paged == dense s{splits}", got,
                    dk.decode_attention_cuda(q, kd, vd, lengths, bkv=PSZ,
                                             splits=splits))
        check_close(f"ragged oracle s{splits}", got,
                    ref.decode_attention(q, kd, vd, lengths), torch.float32)
    done.append("ragged_tails_boundaries_splits")
    # Two slots aliasing the same physical pages with the same q.
    q2 = torch.cat([q[:1], q[:1]])
    alias = torch.tensor([[2, 5, 2], [2, 5, 2]], dtype=torch.int32,
                         device="cuda")
    out = dk.paged_decode_attention_cuda(
        q2, kp, vp, alias, torch.tensor([40, 40], dtype=torch.int32,
                                        device="cuda"), splits=2)
    check_equal("aliased pages", out[0], out[1])
    done.append("aliased_tables")
    # Poisoning every page unreachable below the cursor changes no bit.
    table = torch.tensor([[3, 1, -1, -1], [6, -1, -1, -1]], dtype=torch.int32,
                         device="cuda")
    lens = torch.tensor([2 * PSZ, PSZ - 3], dtype=torch.int32, device="cuda")
    clean = dk.paged_decode_attention_cuda(q[:2], kp, vp, table, lens)
    reach = torch.zeros(N, dtype=torch.bool, device="cuda")
    reach[torch.tensor([3, 1, 6, 0], device="cuda")] = True
    poison_k = torch.where(reach[:, None, None, None], kp, 1e9)
    poison_v = torch.where(reach[:, None, None, None], vp, -1e9)
    check_equal("poisoned unreachable pages", clean,
                dk.paged_decode_attention_cuda(q[:2], poison_k, poison_v,
                                               table, lens))
    done.append("poisoned_unreachable_pages")
    # A parked slot (length 0) yields exactly 0.
    zero = dk.paged_decode_attention_cuda(
        q[:1], kp, vp, pages[:1], torch.zeros(1, dtype=torch.int32,
                                              device="cuda"), splits=3)
    if bool(zero.abs().max() != 0):
        raise AssertionError("length-0 slot must give 0")
    done.append("parked_slot_zero")
    return done


# ---------------------------------------------------------------------------
# Phase 3: serve yi-9b at full width
# ---------------------------------------------------------------------------

def _requests(Request, vocab: int, seed: int, n: int = 48):
    rng = np.random.default_rng(seed)
    lens = rng.integers(32, 1025, size=n)
    budgets = rng.integers(32, 129, size=n)
    return [Request(prompt=rng.integers(0, vocab, size=int(m)).astype(np.int32),
                    max_new_tokens=int(k)) for m, k in zip(lens, budgets)]


def _serve(cfg, params, reqs):
    from repro_torch.serve.engine import ServeEngine

    eng = ServeEngine(cfg, params, batch_slots=SLOTS, max_len=MAX_LEN,
                      chunk_size=8)
    chunk_s = []
    run_chunk = eng._run_chunk

    def timed_chunk():
        t0 = time.perf_counter()
        run_chunk()            # ends in the chunk's device-to-host copy
        chunk_s.append(time.perf_counter() - t0)

    eng._run_chunk = timed_chunk
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    stats = eng.serve_stats()
    del eng
    return wall, chunk_s, stats


def phase_serve(gpu: str, seed: int) -> dict:
    from repro_torch import convert
    from repro_torch.configs import yi_9b
    from repro_torch.kernels.decode_attention import decode_attention as dk
    from repro_torch.serve.engine import Request

    cfg = dataclasses.replace(
        yi_9b.CONFIG, cache_layout="paged", kv_page_size=PSZ,
        decode_kernel="pallas_paged")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    t0 = time.perf_counter()
    params = convert.init(cfg, gen, "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    # Warm-up (cuBLAS handles, allocator): two short requests.
    warm = [Request(prompt=np.arange(40, dtype=np.int32), max_new_tokens=9),
            Request(prompt=np.arange(9, dtype=np.int32), max_new_tokens=3)]
    _serve(cfg, params, warm)

    def counts():
        return {"paged": dk.paged_decode_attention.launches,
                "dense": dk.decode_attention.launches,
                "plain_paged": dk.paged_decode_attention_plain.calls,
                "plain_dense": dk.decode_attention_plain.calls}

    # Each arm's counts are zeroed just before its run and read just after.
    reqs = _requests(Request, cfg.vocab, seed)
    torch.cuda.reset_peak_memory_stats()
    dk.reset_counters()                         # the paged main path
    wall, chunk_s, stats = _serve(cfg, params, reqs)
    counts_paged = counts()
    steps = stats["chunks"] * 8
    if counts_paged != {"paged": cfg.n_layers * steps, "dense": 0,
                        "plain_paged": 0, "plain_dense": 0}:
        raise AssertionError(f"paged arm: launch counts {counts_paged} != "
                             f"{cfg.n_layers} x {steps} paged launches only")
    tokens = sum(len(r.generated) for r in reqs)
    for r in reqs:
        if len(r.generated) != r.max_new_tokens or not all(
                0 <= t < cfg.padded_vocab for t in r.generated):
            raise AssertionError(f"request {r.id}: bad stream")
    peak = torch.cuda.max_memory_allocated()

    gcfg = dataclasses.replace(cfg, decode_kernel="pallas_gather")
    greqs = _requests(Request, cfg.vocab, seed)
    dk.reset_counters()                         # the pallas_gather path
    gwall, gchunk_s, gstats = _serve(gcfg, params, greqs)
    counts_gather = counts()
    gsteps = gstats["chunks"] * 8
    if counts_gather != {"paged": 0, "dense": cfg.n_layers * gsteps,
                         "plain_paged": 0, "plain_dense": 0}:
        raise AssertionError(f"gather arm: launch counts {counts_gather} != "
                             f"{cfg.n_layers} x {gsteps} dense launches only")
    if [r.generated for r in greqs] != [r.generated for r in reqs]:
        raise AssertionError("pallas_gather streams differ from pallas_paged")
    launches = {"paged_decode_attention": counts_paged["paged"],
                "decode_attention": counts_gather["dense"]}
    emit({
        "phase": "serve", "gpu": gpu, "arch": cfg.arch,
        "n_layers": cfg.n_layers, "dtype": cfg.dtype,
        "params": cfg.param_count(), "init_s": init_s,
        "requests": len(reqs), "tokens": tokens, "wall_s": wall,
        "tok_per_s": tokens / wall,
        "mean_ttft_ms": 1e3 * statistics.mean(r.ttft_s for r in reqs),
        "ms_per_chunk": 1e3 * statistics.mean(chunk_s),
        "ms_per_chunk_median": 1e3 * statistics.median(chunk_s),
        "decode_steps": steps, "host_syncs": stats["host_syncs"],
        "host_syncs_per_token": stats["host_syncs_per_token"],
        "admission_waves": stats["admission_waves"],
        "peak_pages_held": stats["peak_pages_held"],
        "max_memory_allocated": peak, "launch_counts": counts_paged,
        "gather": {"wall_s": gwall, "tok_per_s": tokens / gwall,
                   "ms_per_chunk": 1e3 * statistics.mean(gchunk_s),
                   "launch_counts": counts_gather, "streams_equal": True},
    })
    phase_trace(gpu, cfg, params, seed)
    del params
    torch.cuda.empty_cache()
    return launches


def phase_trace(gpu: str, cfg, params, seed: int) -> None:
    """One decode chunk at full width (16 slots of 512 prompt tokens) timed
    untraced, then the next one traced with torch.profiler: device busy
    time, idle share and the kernels that take the time."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serve.engine import Request, ServeEngine

    rng = np.random.default_rng(seed + 2)
    eng = ServeEngine(cfg, params, batch_slots=SLOTS, max_len=MAX_LEN,
                      chunk_size=8)
    eng.submit([Request(prompt=rng.integers(0, cfg.vocab, 512).astype(
        np.int32), max_new_tokens=25) for _ in range(SLOTS)])
    eng.step()                      # admission wave + one warm chunk
    t0 = time.perf_counter()
    eng._run_chunk()                # ends in the chunk's device-to-host copy
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng._run_chunk()
        traced_wall = time.perf_counter() - t0
    # Device-side events only (kernels, copies): an operator's own device
    # time repeats the kernels it launched.
    rows = [(e.self_device_time_total, e.key, e.count)
            for e in prof.key_averages()
            if e.device_type != torch.autograd.DeviceType.CPU
            and e.self_device_time_total > 0]
    rows.sort(reverse=True)
    # A profiler that records no device activity reports "not measured"
    # (null) rather than an idle card.  The idle share is taken against the
    # untraced chunk's wall time (tracing slows the host).
    busy_ms = sum(r[0] for r in rows) / 1e3 if rows else None
    emit({"phase": "trace", "gpu": gpu, "chunk_steps": 8,
          "chunk_wall_ms": 1e3 * wall, "traced_wall_ms": 1e3 * traced_wall,
          "device_busy_ms": busy_ms,
          "device_idle_share": (None if busy_ms is None
                                else 1 - busy_ms / (1e3 * wall)),
          "top": [{"name": k[:80], "ms": us / 1e3, "count": c}
                  for us, k, c in rows[:10]]})


# ---------------------------------------------------------------------------
# Phase 4: kernel path against the plain path, end to end
# ---------------------------------------------------------------------------

def phase_e2e(gpu: str, seed: int) -> None:
    from repro_torch import convert
    from repro_torch.configs import yi_9b
    from repro_torch.models import build_model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    base = dataclasses.replace(
        yi_9b.CONFIG, n_layers=4, dtype="float32", cache_layout="paged",
        kv_page_size=PSZ)
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    params = convert.init(base, gen, "cuda")
    b, max_len = 4, 256
    rng = np.random.default_rng(seed)
    seg = torch.tensor([100, 37, 64, 5], dtype=torch.int32, device="cuda")
    toks = torch.from_numpy(
        rng.integers(0, base.vocab, size=(b, 128)).astype(np.int32)).to("cuda")
    errs = []
    with torch.inference_mode():
        models, caches = {}, {}
        for kern in ("pallas_paged", "xla"):
            m = build_model(dataclasses.replace(base, decode_kernel=kern),
                            "cuda")
            c = m.init_cache(params, batch=b, max_len=max_len)
            c["pages"] = torch.arange(
                c["pages"].numel(), dtype=torch.int32,
                device="cuda").reshape(c["pages"].shape)
            models[kern], caches[kern] = m, c
        logits = {}
        for kern, m in models.items():
            logits[kern], caches[kern] = m.prefill(params, caches[kern], toks,
                                                   seg_lens=seg)
        errs.append(check_close("e2e prefill", logits["pallas_paged"],
                                logits["xla"], torch.float32))
        for step in range(4):
            nxt = logits["xla"][:, -1].argmax(-1).to(torch.int32)[:, None]
            active = torch.tensor([1, 1, step % 2, 1], dtype=torch.int32,
                                  device="cuda")
            for kern, m in models.items():
                logits[kern], caches[kern] = m.decode_step(
                    params, caches[kern], nxt, seg_lens=active)
            errs.append(check_close(f"e2e decode {step}",
                                    logits["pallas_paged"], logits["xla"],
                                    torch.float32))
    emit({"phase": "e2e", "gpu": gpu, "arch": base.arch, "n_layers": 4,
          "dtype": "float32", "max_abs_err": max(errs), "tol": 2e-3})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only",
              file=sys.stderr)
        return 1
    from repro_torch.kernels.decode_attention import decode_attention as dk

    gpu = card_line()
    t0 = time.perf_counter()
    dk._kernel()
    emit({"phase": "card", "gpu": gpu, "torch": torch.__version__,
          "cuda": torch.version.cuda, "build_s": time.perf_counter() - t0})
    kern = phase_kernels(gpu, args.seed)
    launches = phase_serve(gpu, args.seed)
    phase_e2e(gpu, args.seed)
    main_row = kern["main"]
    summary = []
    for name, ms_key, plain_key in (
            ("paged_decode_attention", "paged_ms", "plain_ms"),
            ("decode_attention", "dense_ms", "dense_plain_ms")):
        summary.append({
            "name": name, "route": "cuda", "source": KERNEL_SOURCE,
            "replaces": TPU_SITES[name], "launches": launches[name],
            "max_abs_err": kern["errs"][name], "ms": main_row[ms_key],
            "plain_ms": main_row[plain_key],
            "bound_ms": main_row["bound_ms"],
            "bound_by": main_row["bound_by"],
            "library_ms": main_row["library_ms"],
        })
    emit({"kernels": summary})
    print(gpu, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
