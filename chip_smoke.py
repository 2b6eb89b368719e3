#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA H100.

    python3 chip_smoke.py [--seed N]

Phases, each printing one JSON line; any failure raises and exits non-zero:

1. card and build: the card's name and power limit, the CUDA version, and
   the time to build the three CUDA kernels (split-KV decode attention,
   flash attention, fused norm, one nvcc each, started together) from
   src/repro_torch/kernels/*/csrc/*.cu for sm_90a into build/repro_torch/;
2. kernels against their plain PyTorch versions on the card, bf16 and fp32,
   tolerance (TOL) fp32 2e-3, bf16 4e-3 + 2^-7 |want|:
   * decode attention at yi-9b's decode shapes (hq 32, hkv 4, d 128,
     page 16, 16 slots, contexts 512 and 2048, splits 1 and planned),
     paged == dense bitwise, the reference's property cases;
   * flash attention at the prefill's main shape (16 x 1024 causal), at
     the serve path's ragged shape (pad 1024 over a 2048-position page
     view, per-slot offsets, key and query lengths, parked slots; paged ==
     dense bitwise) and a prefix attach (a 512-token suffix at offset 512
     over shared pages) against the whole prompt's rows;
   * fused norm at 16 x 1024 x 4096 and 16 x 1 x 4096 (RMS with and
     without residual, LayerNorm with bias);
   with device timings (CUDA graph replay, CUDA events) of kernel, plain
   version, the nearest PyTorch library call and the least time the work
   can take (the bound);
3. serve yi-9b at its published config (48 layers, bf16, random weights
   from a seed) through ServeEngine over a paged pool: 48 greedy requests,
   every kernel's launch count checked (decode 48 x steps, flash 48 x
   waves, fused norm 97 x (waves + steps), 0 plain calls), then the first
   16 of those requests under pallas_gather with bitwise-equal streams;
   a torch.profiler trace of one decode chunk and of one admission wave
   (device busy time, idle share, kernels by device time);
4. prefix sharing and preemption at the same width: 48 requests on four
   shared 512-token system prompts over a 256-page pool, invariants
   checked after every wave, hits and preemptions required, no page left
   held; the same requests with sharing off for comparison;
5. the kernel path against the plain path end to end: yi-9b's width at 4
   layers in fp32, prefill, decode steps and a continuation prefill at a
   nonzero cursor, logits within 2e-3.

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
SOURCES = {
    "decode_attention":
        "src/repro_torch/kernels/decode_attention/csrc/decode_attention.cu",
    "flash_attention":
        "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
    "fused_norm": "src/repro_torch/kernels/fused_norm/csrc/fused_norm.cu",
}
TPU_SITES = {
    "paged_decode_attention":
        "src/repro/kernels/decode_attention/decode_attention.py:274",
    "decode_attention":
        "src/repro/kernels/decode_attention/decode_attention.py:106",
    "flash_attention": "src/repro/kernels/flash_attention/flash_attention.py:129",
    "fused_norm": "src/repro/kernels/fused_norm/fused_norm.py:73",
}
PREFILL_PAD = 1024          # the serve traffic's widest prefill bucket


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
# Phase 2 (cont.): flash attention and fused norm
# ---------------------------------------------------------------------------

def _esize(dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def _flash_bound(dtype, q_len, kv_need, pairs, b, sq, hq, hkv, d):
    """Least time for one flash call: the valid query rows and the keys
    the run needs read once, the whole output written once, against
    4 * d flops per valid (query head, key) pair at the type's peak."""
    es = _esize(dtype)
    nbytes = (int(q_len.sum()) * hq * d * es          # q rows read
              + b * sq * hq * d * es                  # out written
              + 2 * int(kv_need.sum()) * hkv * d * es  # K and V read
              + 12 * b)                               # per-slot vectors
    ops = 4 * int(pairs) * hq * d
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _flash_work(off, q_len, kv_len):
    """(keys needed per slot, valid causal query-key pairs) of a call."""
    off, q_len, kv_len = (x.long().cpu() for x in (off, q_len, kv_len))
    pairs, need = 0, []
    for o, n, t in zip(off.tolist(), q_len.tolist(), kv_len.tolist()):
        rows = torch.arange(n)
        pairs += int(torch.clamp(torch.minimum(o + rows + 1,
                                               torch.tensor(t)), min=0).sum())
        need.append(max(0, min(t, o + n)) if n else 0)
    return torch.tensor(need), pairs


def _paged_pool(gen, dtype, b, n_table, n_pages):
    kp = torch.randn(n_pages, PSZ, HKV, D, generator=gen,
                     device="cuda").to(dtype)
    vp = torch.randn(n_pages, PSZ, HKV, D, generator=gen,
                     device="cuda").to(dtype)
    perm = torch.randperm(n_pages, generator=gen, device="cuda")
    return kp, vp, perm[:b * n_table].reshape(b, n_table).to(torch.int32)


def phase_flash(gpu: str, seed: int) -> dict:
    """Flash attention on the card: the prefill's main shape (timed against
    SDPA), the serve path's ragged paged shape (paged == dense bitwise)
    and a prefix attach, each against the plain version."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import flash_attention as fk
    from repro_torch.models.common import gather_pages

    gen = torch.Generator(device="cuda").manual_seed(seed + 10)
    rows, err = [], 0.0
    b, sq = SLOTS, PREFILL_PAD
    main = {}
    for dtype in (torch.bfloat16, torch.float32):
        q = torch.randn(b, HQ, sq, D, generator=gen, device="cuda").to(dtype)
        k = torch.randn(b, HKV, sq, D, generator=gen, device="cuda").to(dtype)
        v = torch.randn(b, HKV, sq, D, generator=gen, device="cuda").to(dtype)

        def kernel():
            return fk.flash_attention_cuda(q, k, v, causal=True)

        def plain():
            return fk.flash_attention_plain(q, k, v, causal=True)

        def library():
            return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                  enable_gqa=True)

        got, want = kernel(), plain()
        torch.cuda.synchronize()
        e = check_close(f"flash main {dtype}", got, want, dtype)
        err = max(err, e)
        full = torch.full((b,), sq, dtype=torch.int32)
        need, pairs = _flash_work(torch.zeros(b), full, full)
        bound_ms, bound_by = _flash_bound(dtype, full, need, pairs, b, sq,
                                          HQ, HKV, D)
        row = {"case": "main", "dtype": str(dtype).removeprefix("torch."),
               "shape": [b, HQ, HKV, sq, sq, D], "causal": True,
               "err": e, "library_err": (library().float() - want.float()
                                         ).abs().max().item(),
               "ms": time_ms(kernel), "plain_ms": time_ms(plain, reps=5),
               "library_ms": time_ms(library), "bound_ms": bound_ms,
               "bound_by": bound_by, "gflop": 4 * pairs * HQ * D / 1e9}
        rows.append(row)
        if dtype == torch.bfloat16:
            main = row
        del q, k, v, got, want
    # The serve path's ragged prefill: slots at random cursors with random
    # suffix lengths (two parked), K/V read through a 2048-position table.
    n_table = MAX_LEN // PSZ
    for dtype in (torch.bfloat16, torch.float32):
        kp, vp, pages = _paged_pool(gen, dtype, b, n_table, b * n_table)
        off = torch.randint(0, MAX_LEN - sq + 1, (b,), generator=gen,
                            device="cuda", dtype=torch.int32)
        q_len = torch.randint(1, sq + 1, (b,), generator=gen,
                              device="cuda", dtype=torch.int32)
        q_len[3] = 0
        q_len[7] = 0
        kv_len = (off + q_len).to(torch.int32)
        mapped = (kv_len.long() + PSZ - 1) // PSZ
        pages = torch.where(torch.arange(n_table, device="cuda")[None]
                            < mapped[:, None], pages, -1).to(torch.int32)
        pages = pages.contiguous()
        q = torch.randn(b, sq, HQ, D, generator=gen,
                        device="cuda").to(dtype).transpose(1, 2)
        kd = gather_pages(kp, pages).transpose(1, 2)
        vd = gather_pages(vp, pages).transpose(1, 2)
        kw = dict(q_offset=off, kv_len=kv_len, q_len=q_len)

        def paged():
            return fk.paged_flash_attention_cuda(q, kp, vp, pages, **kw)

        def dense():
            return fk.flash_attention_cuda(q, kd, vd, **kw)

        def plain():
            return fk.paged_flash_attention_plain(q, kp, vp, pages, **kw)

        kdc, vdc = kd.contiguous(), vd.contiguous()
        kpos = torch.arange(kd.shape[2], device="cuda")
        qpos = off[:, None].long() + torch.arange(sq, device="cuda")
        mask = ((kpos[None, None] < kv_len[:, None, None])
                & (kpos[None, None] <= qpos[:, :, None]))[:, None]

        def library():
            return F.scaled_dot_product_attention(q, kdc, vdc,
                                                  attn_mask=mask,
                                                  enable_gqa=True)

        out_p, out_d, want = paged(), dense(), plain()
        torch.cuda.synchronize()
        check_equal(f"flash ragged paged == dense {dtype}", out_p, out_d)
        e = check_close(f"flash ragged {dtype}", out_p, want, dtype)
        if bool(out_p[3].abs().max() != 0) or bool(out_p[7].abs().max() != 0):
            raise AssertionError("flash: a parked slot must give zeros")
        err = max(err, e)
        need, pairs = _flash_work(off, q_len, kv_len)
        bound_ms, bound_by = _flash_bound(dtype, q_len.cpu(), need, pairs, b,
                                          sq, HQ, HKV, D)
        rows.append({"case": "ragged_paged",
                     "dtype": str(dtype).removeprefix("torch."),
                     "q_len": q_len.tolist(), "q_offset": off.tolist(),
                     "err": e, "paged_equals_dense": True,
                     "ms": time_ms(paged), "dense_ms": time_ms(dense),
                     "plain_ms": time_ms(plain, reps=5),
                     "library_ms": time_ms(library),
                     "bound_ms": bound_ms, "bound_by": bound_by})
        del kp, vp, q, kd, vd, kdc, vdc, mask, out_p, out_d, want
    # Prefix attach: each slot's table starts with one of four shared
    # 512-token prefixes (32 pages another slot's prefill wrote) and ends
    # in its own suffix pages; the suffix at q_offset 512 must give the
    # rows the whole prompt gives.
    dtype, pre = torch.bfloat16, 512
    n_own = (sq - pre) // PSZ
    n_pages = 4 * (pre // PSZ) + b * n_own
    kp, vp, perm = _paged_pool(gen, dtype, 1, n_pages, n_pages)
    perm = perm[0]
    shared = perm[:4 * (pre // PSZ)].reshape(4, pre // PSZ)
    own = perm[4 * (pre // PSZ):].reshape(b, n_own)
    pages = torch.cat([shared[torch.arange(b, device="cuda") % 4], own],
                      dim=1).to(torch.int32).contiguous()
    q = torch.randn(b, HQ, sq, D, generator=gen, device="cuda").to(dtype)
    full = torch.full((b,), sq, dtype=torch.int32, device="cuda")
    whole = fk.paged_flash_attention_cuda(q, kp, vp, pages, kv_len=full)
    attached = fk.paged_flash_attention_cuda(
        q[:, :, pre:], kp, vp, pages,
        q_offset=torch.full((b,), pre, dtype=torch.int32, device="cuda"),
        kv_len=full)
    torch.cuda.synchronize()
    e_attach = check_close("flash prefix attach", attached,
                           whole[:, :, pre:], dtype)
    e_plain = check_close(
        "flash prefix attach vs plain", attached,
        fk.paged_flash_attention_plain(
            q[:, :, pre:], kp, vp, pages,
            q_offset=torch.full((b,), pre, dtype=torch.int32, device="cuda"),
            kv_len=full), dtype)
    err = max(err, e_attach, e_plain)
    rows.append({"case": "prefix_attach", "dtype": "bfloat16",
                 "prefix": pre, "suffix": sq - pre, "err": e_attach,
                 "plain_err": e_plain,
                 "bitwise_equal": bool(torch.equal(attached,
                                                   whole[:, :, pre:]))})
    emit({"phase": "kernels_flash", "gpu": gpu, "rows": rows})
    return {"main": main, "err": err}


def phase_norm(gpu: str, seed: int) -> dict:
    """Fused norm on the card at the prefill and decode shapes of yi-9b
    (d 4096): RMS with and without residual, LayerNorm with bias, against
    the plain version, timed against F.rms_norm / F.layer_norm."""
    import torch.nn.functional as F

    from repro_torch.kernels.fused_norm import fused_norm as nk

    gen = torch.Generator(device="cuda").manual_seed(seed + 20)
    d, eps = 4096, 1e-5
    rows, err, main = [], 0.0, {}
    for dtype in (torch.bfloat16, torch.float32):
        for shape in ((SLOTS, PREFILL_PAD, d), (SLOTS, 1, d)):
            x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
            r = torch.randn(shape, generator=gen, device="cuda").to(dtype)
            w = torch.randn(d, generator=gen, device="cuda")
            bias = torch.randn(d, generator=gen, device="cuda")
            w_lib, b_lib = w.to(dtype), bias.to(dtype)   # F.* take x's type
            for kind, b_, r_ in (("rms", None, None), ("rms", None, r),
                                 ("layer", bias, None)):
                kw = dict(eps=eps, kind=kind)

                def kernel():
                    return nk.fused_norm_cuda(x, w, b_, r_, **kw)

                def plain():
                    return nk.fused_norm_plain(x, w, b_, r_, **kw)

                library = None
                if r_ is None and kind == "rms":
                    def library():
                        return F.rms_norm(x, (d,), w_lib, eps)
                elif r_ is None:
                    def library():
                        return F.layer_norm(x, (d,), w_lib, b_lib, eps)

                got = kernel()
                torch.cuda.synchronize()
                e = check_close(f"norm {kind} {shape} {dtype}", got, plain(),
                                dtype)
                err = max(err, e)
                es = _esize(dtype)
                nbytes = (x.numel() * es * (3 if r_ is not None else 2)
                          + 4 * d * (2 if b_ is not None else 1))
                ops = x.numel() * (8 if kind == "layer" else 5)
                t_b, t_o = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS[dtype]
                row = {"dtype": str(dtype).removeprefix("torch."),
                       "shape": list(shape), "kind": kind,
                       "residual": r_ is not None, "bias": b_ is not None,
                       "err": e, "ms": time_ms(kernel),
                       "plain_ms": time_ms(plain),
                       "library_ms": (time_ms(library) if library
                                      else None),
                       "bound_ms": max(t_b, t_o) * 1e3,
                       "bound_by": "bytes" if t_b >= t_o else "operations"}
                rows.append(row)
                if (dtype == torch.bfloat16 and shape[1] == PREFILL_PAD
                        and kind == "rms" and r_ is None):
                    main = row
    emit({"phase": "kernels_norm", "gpu": gpu, "rows": rows})
    return {"main": main, "err": err}


# ---------------------------------------------------------------------------
# Phase 3: serve yi-9b at full width
# ---------------------------------------------------------------------------

def _requests(Request, vocab: int, seed: int, n: int = 48):
    rng = np.random.default_rng(seed)
    lens = rng.integers(32, 1025, size=n)
    budgets = rng.integers(32, 129, size=n)
    return [Request(prompt=rng.integers(0, vocab, size=int(m)).astype(np.int32),
                    max_new_tokens=int(k)) for m, k in zip(lens, budgets)]


def _serve(cfg, params, reqs, n_pages=None):
    from repro_torch.serve.engine import ServeEngine

    eng = ServeEngine(cfg, params, batch_slots=SLOTS, max_len=MAX_LEN,
                      chunk_size=8, n_pages=n_pages)
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
    held = (eng.n_pages - eng.allocator.free_count()) if eng.paged else 0
    del eng
    return wall, chunk_s, stats, held


def _kernel_modules():
    from repro_torch.kernels.decode_attention import decode_attention as dk
    from repro_torch.kernels.flash_attention import flash_attention as fk
    from repro_torch.kernels.fused_norm import fused_norm as nk

    return dk, fk, nk


def reset_counts() -> None:
    """Zero every kernel's launch and plain-call counters."""
    for mod in _kernel_modules():
        mod.reset_counters()


def counts() -> dict:
    dk, fk, nk = _kernel_modules()
    return {"decode_paged": dk.paged_decode_attention.launches,
            "decode_dense": dk.decode_attention.launches,
            "flash_paged": fk.paged_flash_attention.launches,
            "flash_dense": fk.flash_attention.launches,
            "fused_norm": nk.fused_norm.launches,
            "plain": (dk.paged_decode_attention_plain.calls
                      + dk.decode_attention_plain.calls
                      + fk.paged_flash_attention_plain.calls
                      + fk.flash_attention_plain.calls
                      + nk.fused_norm_plain.calls)}


def check_counts(arm: str, got: dict, cfg, stats: dict) -> None:
    """Every prefill launches one flash kernel a layer, every decode step
    one decode kernel a layer, and both 2 norms a layer plus the final
    one; nothing takes a plain version."""
    L, steps = cfg.n_layers, stats["chunks"] * 8
    waves = stats["admission_waves"]
    paged = cfg.decode_kernel == "pallas_paged"
    want = {"decode_paged": L * steps if paged else 0,
            "decode_dense": 0 if paged else L * steps,
            "flash_paged": L * waves if paged else 0,
            "flash_dense": 0 if paged else L * waves,
            "fused_norm": (2 * L + 1) * (waves + steps), "plain": 0}
    if got != want:
        raise AssertionError(f"{arm} arm: launch counts {got} != {want}")


def check_streams(arm: str, reqs, cfg) -> None:
    for r in reqs:
        if len(r.generated) != r.max_new_tokens or not all(
                0 <= t < cfg.padded_vocab for t in r.generated):
            raise AssertionError(f"{arm} arm: request {r.id}: bad stream")


def phase_serve(gpu: str, seed: int) -> dict:
    from repro_torch import convert
    from repro_torch.configs import yi_9b
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

    # Each arm's counts are zeroed just before its run and read just after.
    reqs = _requests(Request, cfg.vocab, seed)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()                              # the paged main path
    wall, chunk_s, stats, _ = _serve(cfg, params, reqs)
    counts_paged = counts()
    check_counts("paged", counts_paged, cfg, stats)
    check_streams("paged", reqs, cfg)
    tokens = sum(len(r.generated) for r in reqs)
    peak = torch.cuda.max_memory_allocated()

    # The bitwise twin over the first 16 requests (the first wave's): each
    # slot's arithmetic does not depend on what the other slots hold.
    gcfg = dataclasses.replace(cfg, decode_kernel="pallas_gather")
    greqs = _requests(Request, cfg.vocab, seed)[:SLOTS]
    reset_counts()                              # the pallas_gather path
    gwall, gchunk_s, gstats, _ = _serve(gcfg, params, greqs)
    counts_gather = counts()
    check_counts("gather", counts_gather, gcfg, gstats)
    if [r.generated for r in greqs] != [r.generated for r in reqs[:SLOTS]]:
        raise AssertionError("pallas_gather streams differ from pallas_paged")
    gtokens = sum(len(r.generated) for r in greqs)
    emit({
        "phase": "serve", "gpu": gpu, "arch": cfg.arch,
        "n_layers": cfg.n_layers, "dtype": cfg.dtype,
        "params": cfg.param_count(), "init_s": init_s,
        "requests": len(reqs), "tokens": tokens, "wall_s": wall,
        "tok_per_s": tokens / wall,
        "mean_ttft_ms": 1e3 * statistics.mean(r.ttft_s for r in reqs),
        "ms_per_chunk": 1e3 * statistics.mean(chunk_s),
        "ms_per_chunk_median": 1e3 * statistics.median(chunk_s),
        "decode_steps": stats["chunks"] * 8,
        "host_syncs": stats["host_syncs"],
        "host_syncs_per_token": stats["host_syncs_per_token"],
        "admission_waves": stats["admission_waves"],
        "peak_pages_held": stats["peak_pages_held"],
        "max_memory_allocated": peak, "launch_counts": counts_paged,
        "gather": {"requests": len(greqs), "tokens": gtokens,
                   "wall_s": gwall, "tok_per_s": gtokens / gwall,
                   "ms_per_chunk": 1e3 * statistics.mean(gchunk_s),
                   "launch_counts": counts_gather, "streams_equal": True},
    })
    phase_trace(gpu, cfg, params, seed)
    return {"cfg": cfg, "params": params, "launches": counts_paged,
            "gather_launches": counts_gather}


def _profile_rows(prof):
    """Device-side events only (kernels, copies): an operator's own device
    time repeats the kernels it launched."""
    rows = [(e.self_device_time_total, e.key, e.count)
            for e in prof.key_averages()
            if e.device_type != torch.autograd.DeviceType.CPU
            and e.self_device_time_total > 0]
    rows.sort(reverse=True)
    return rows


def _trace_line(what: str, wall: float, traced_wall: float, rows) -> dict:
    # A profiler that records no device activity reports "not measured"
    # (null) rather than an idle card.  The idle share is taken against the
    # untraced run's wall time (tracing slows the host).
    busy_ms = sum(r[0] for r in rows) / 1e3 if rows else None
    return {"what": what, "wall_ms": 1e3 * wall,
            "traced_wall_ms": 1e3 * traced_wall, "device_busy_ms": busy_ms,
            "device_idle_share": (None if busy_ms is None
                                  else 1 - busy_ms / (1e3 * wall)),
            "top": [{"name": k[:80], "ms": us / 1e3, "count": c}
                    for us, k, c in rows[:10]]}


def phase_trace(gpu: str, cfg, params, seed: int) -> None:
    """One decode chunk at full width (16 slots of 512 prompt tokens), then
    one admission wave (16 prompts of 1000 tokens, pad 1024), each timed
    untraced and then traced with torch.profiler: device busy time, idle
    share and the kernels that take the time."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serve.engine import Request, ServeEngine

    rng = np.random.default_rng(seed + 2)
    eng = ServeEngine(cfg, params, batch_slots=SLOTS, max_len=MAX_LEN,
                      chunk_size=8)

    def prompts(n_tokens, budget):
        return [Request(prompt=rng.integers(0, cfg.vocab, n_tokens).astype(
            np.int32), max_new_tokens=budget) for _ in range(SLOTS)]

    eng.submit(prompts(512, 25))
    eng.step()                      # admission wave + one warm chunk
    t0 = time.perf_counter()
    eng._run_chunk()                # ends in the chunk's device-to-host copy
    wall = time.perf_counter() - t0
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        eng._run_chunk()            # the last: every budget runs out
        traced_wall = time.perf_counter() - t0
    chunk = _trace_line("decode_chunk", wall, traced_wall,
                        _profile_rows(prof))
    waves = []
    for traced in (False, True):
        for _, r in eng._live():    # vacate the slots for a full wave
            eng.cancel(r.id)
        eng._sweep_lifecycle()
        eng.submit(prompts(1000, 2))
        torch.cuda.synchronize()
        if traced:
            with profile(activities=acts) as prof:
                t0 = time.perf_counter()
                eng._admit_wave()   # ends in the wave's device-to-host copy
                waves.append(time.perf_counter() - t0)
        else:
            t0 = time.perf_counter()
            eng._admit_wave()
            waves.append(time.perf_counter() - t0)
    wave = _trace_line("admission_wave", waves[0], waves[1],
                       _profile_rows(prof))
    emit({"phase": "trace", "gpu": gpu, "chunk_steps": 8,
          "wave_slots": SLOTS, "wave_prompt": 1000, "chunk": chunk,
          "wave": wave})


# ---------------------------------------------------------------------------
# Phase 4: prefix sharing and preemption at full width
# ---------------------------------------------------------------------------

PREFIX_POOL = 256           # pages of 16: below the 16 slots' worst case


def _prefix_requests(Request, vocab: int, seed: int, n: int = 48):
    """Each request is one of four 512-token system prompts plus a unique
    suffix of 16-256 tokens, with a budget of 32-128."""
    rng = np.random.default_rng(seed + 3)
    system = [rng.integers(0, vocab, 512).astype(np.int32) for _ in range(4)]
    out = []
    for _ in range(n):
        head = system[int(rng.integers(0, 4))]
        tail = rng.integers(0, vocab, int(rng.integers(16, 257)))
        out.append(Request(prompt=np.concatenate(
            [head, tail.astype(np.int32)]),
            max_new_tokens=int(rng.integers(32, 129))))
    return out


def phase_prefix(gpu: str, seed: int, cfg, params) -> None:
    """Serve the shared-prompt traffic with prefix sharing and preemption
    over a 256-page pool, invariants checked after every wave; then the
    same requests with sharing off."""
    from repro_torch.serve.engine import Request

    pcfg = dataclasses.replace(cfg, prefix_sharing=True, preemption=True,
                               strict_invariants=True)
    reqs = _prefix_requests(Request, cfg.vocab, seed)
    reset_counts()                              # the prefix arm
    wall, chunk_s, stats, held = _serve(pcfg, params, reqs,
                                        n_pages=PREFIX_POOL)
    got = counts()
    check_counts("prefix", got, pcfg, stats)
    check_streams("prefix", reqs, pcfg)
    if stats["prefix_hits_fresh"] <= 0 or stats["preempted"] <= 0:
        raise AssertionError(f"prefix arm: hits {stats['prefix_hits_fresh']}"
                             f", preemptions {stats['preempted']}: both "
                             "must be > 0")
    if held:
        raise AssertionError(f"prefix arm: {held} pages held after drain")
    if stats["invariant_checks"] < stats["admission_waves"]:
        raise AssertionError("prefix arm: invariants not checked every wave")
    tokens = sum(len(r.generated) for r in reqs)

    ocfg = dataclasses.replace(pcfg, prefix_sharing=False)
    oreqs = _prefix_requests(Request, cfg.vocab, seed)
    owall, _, ostats, oheld = _serve(ocfg, params, oreqs,
                                     n_pages=PREFIX_POOL)
    check_streams("sharing-off", oreqs, ocfg)
    equal = sum(a.generated == b.generated for a, b in zip(reqs, oreqs))
    first_equal = sum(a.generated[0] == b.generated[0]
                      for a, b in zip(reqs, oreqs))
    emit({"phase": "prefix", "gpu": gpu, "arch": cfg.arch,
          "n_layers": cfg.n_layers, "dtype": cfg.dtype,
          "requests": len(reqs), "pool_pages": PREFIX_POOL,
          "tokens": tokens, "wall_s": wall, "tok_per_s": tokens / wall,
          "mean_ttft_ms": 1e3 * statistics.mean(r.ttft_s for r in reqs),
          "ms_per_chunk": 1e3 * statistics.mean(chunk_s),
          "prefix_hits_fresh": stats["prefix_hits_fresh"],
          "prefix_hit_rate": stats["prefix_hit_rate"],
          "prefix_tokens_shared": stats["prefix_tokens_shared"],
          "prefill_work_tokens": stats["prefill_work_tokens"],
          "preempted": stats["preempted"],
          "recompute_tokens": stats["recompute_tokens"],
          "admission_waves": stats["admission_waves"],
          "invariant_checks": stats["invariant_checks"],
          "peak_pages_held": stats["peak_pages_held"],
          "pages_held_after_drain": held, "launch_counts": got,
          "sharing_off": {"wall_s": owall,
                          "tok_per_s": tokens / owall,
                          "mean_ttft_ms": 1e3 * statistics.mean(
                              r.ttft_s for r in oreqs),
                          "preempted": ostats["preempted"],
                          "prefill_work_tokens":
                              ostats["prefill_work_tokens"],
                          "admission_waves": ostats["admission_waves"],
                          "pages_held_after_drain": oheld},
          "streams_equal_sharing_off": equal,
          "first_tokens_equal_sharing_off": first_equal})


# ---------------------------------------------------------------------------
# Phase 5: kernel path against the plain path, end to end
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
        # A continuation prefill at each slot's nonzero cursor (the flash
        # kernel's q_offset case), slot 1 parked: a parked slot's logits
        # are garbage by contract (the kernel gives its rows zeros, the
        # plain path attends), so only the others are compared.
        more = torch.from_numpy(rng.integers(
            0, base.vocab, size=(b, 32)).astype(np.int32)).to("cuda")
        seg2 = torch.tensor([32, 0, 17, 9], dtype=torch.int32,
                            device="cuda")
        for kern, m in models.items():
            logits[kern], caches[kern] = m.prefill(params, caches[kern],
                                                   more, seg_lens=seg2)
        live = seg2 > 0
        errs.append(check_close("e2e continuation prefill",
                                logits["pallas_paged"][live],
                                logits["xla"][live], torch.float32))
        check_equal("e2e cursors", caches["pallas_paged"]["lengths"],
                    caches["xla"]["lengths"])
    emit({"phase": "e2e", "gpu": gpu, "arch": base.arch, "n_layers": 4,
          "steps": ["prefill", "decode x 4", "continuation prefill"],
          "dtype": "float32", "max_abs_err": max(errs), "tol": 2e-3})


def build_kernels() -> float:
    """Build every kernel (one nvcc per source, started together), then
    load each; returns the seconds it took."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels.common import build_library

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        list(pool.map(build_library, (ROOT / s for s in SOURCES.values())))
    for mod in _kernel_modules():
        mod._kernel()
    return time.perf_counter() - t0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only",
              file=sys.stderr)
        return 1
    gpu = card_line()
    emit({"phase": "card", "gpu": gpu, "torch": torch.__version__,
          "cuda": torch.version.cuda, "build_s": build_kernels()})
    kern = phase_kernels(gpu, args.seed)
    flash = phase_flash(gpu, args.seed)
    norm = phase_norm(gpu, args.seed)
    serve = phase_serve(gpu, args.seed)
    phase_prefix(gpu, args.seed, serve["cfg"], serve["params"])
    del serve["params"]
    torch.cuda.empty_cache()
    phase_e2e(gpu, args.seed)
    dec, launches = kern["main"], serve["launches"]
    summary = []
    for name, ms_key, plain_key, count in (
            ("paged_decode_attention", "paged_ms", "plain_ms",
             launches["decode_paged"]),
            ("decode_attention", "dense_ms", "dense_plain_ms",
             serve["gather_launches"]["decode_dense"])):
        summary.append({
            "name": name, "route": "cuda",
            "source": SOURCES["decode_attention"],
            "replaces": TPU_SITES[name], "launches": count,
            "max_abs_err": kern["errs"][name], "ms": dec[ms_key],
            "plain_ms": dec[plain_key], "bound_ms": dec["bound_ms"],
            "bound_by": dec["bound_by"], "library_ms": dec["library_ms"],
        })
    for name, res, count in (
            ("flash_attention", flash,
             launches["flash_paged"] + launches["flash_dense"]),
            ("fused_norm", norm, launches["fused_norm"])):
        row = res["main"]
        summary.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": TPU_SITES[name], "launches": count,
            "max_abs_err": res["err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
        })
    emit({"kernels": summary})
    print(gpu, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
