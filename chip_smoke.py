#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA H100.

    python3 chip_smoke.py [--seed N]

Phases, each printing one JSON line; any failure raises and exits non-zero:

1. card and build: the card's name and power limit, the CUDA version, its
   properties (SMs, memory, L2) beside the policy engine's H100 model, and
   the time to build the six CUDA kernels (split-KV decode attention,
   flash attention, fused norm, the Mamba-2 SSD scan, the MoE grouped GEMM,
   the policy-planned matmul; one nvcc each, started together) from
   src/repro_torch/kernels/*/csrc/*.cu for sm_90a into build/repro_torch/;
2. kernels against their plain PyTorch versions on the card, bf16 and fp32,
   tolerance (TOL) fp32 2e-3, bf16 4e-3 + 2^-7 |want|:
   * decode attention at yi-9b's decode shapes (hq 32, hkv 4, d 128,
     page 16, 16 slots, contexts 512 and 2048, splits 1, the count the
     policy engine plans for the serve engine (4) and 8, the count of the
     plan-free default), paged == dense bitwise, the reference's property
     cases;
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
   nonzero cursor, logits within 2e-3;
6. the SSD scan kernel against its plain version, bf16 and fp32, at
   mamba2-1.3b's prefill shape (16 x 1024, 64 heads of 64, state 128) and
   zamba2-2.7b's (80 heads, state 64) and a grouped case, each from a
   nonzero initial state with ragged dt-zero tails and a parked slot whose
   state must come back bitwise; timed beside its bound (no PyTorch call
   computes the scan, so no library time);
7. decode and flash attention at zamba2's shapes (32 query and 32 KV heads,
   head dim 80), paged == dense bitwise, timed beside SDPA;
8. serve zamba2-2.7b at its published config (54 Mamba-2 layers and 9
   shared-attention invocations, bf16, random weights) over a paged pool:
   the same 48 requests, launch counts checked (ssd 54 x waves, flash
   9 x waves, decode 9 x steps, fused norm 73 x (waves + steps), 0 plain
   calls), the first 16 under pallas_gather with bitwise-equal streams, a
   trace of one decode chunk and one admission wave; then the 48 requests
   on a 256-page pool with preemption and invariants after every wave;
9. serve mamba2-1.3b at its published config (48 layers, bf16) with a paged
   layout requested: the engine falls back to contiguous bookkeeping;
   launch counts ssd 48 x waves, fused norm 49 x (waves + steps), no
   attention, 0 plain calls;
10. kernel path against plain path end to end for mamba2 (full width, 4
   layers) and zamba2 (full width, 12 layers: two groups), fp32, as in 5;
11. the MoE grouped GEMM against its plain version, bf16 and fp32, at
   olmoe-1b-7b's expert products: a dense-dispatch prefill wave through
   wg/wu and through wd, a decode step, a sorted-dispatch wave's capacity
   buffers with counts (rows past each count exactly 0) and ragged shapes,
   timed beside its bound and torch.bmm;
12. serve olmoe-1b-7b at its published config (16 layers, 64 experts top 8,
   bf16, random weights) over a paged pool under dense dispatch: the same
   48 requests, launch counts checked (grouped GEMM 3 x 16 x (waves +
   steps), flash 16 x waves, decode 16 x steps, fused norm 33 x (waves +
   steps), 0 plain calls), the first 16 under pallas_gather with
   bitwise-equal streams, a trace of one decode chunk and one admission
   wave;
13. olmoe end to end at full width (4 layers, fp32): kernel route against
   plain route under dense and under sorted dispatch (there with a
   prefill free of padding rows, which would contend for capacity), and
   sorted dispatch (capacity factor 8, nothing dropped) against dense, as
   in 5;
14. the policy-planned matmul, the main path of the cache-policy core:
   make_engine(mode, rinse, chip="h100") -> plan_op(matmul_op(...)) ->
   kernels.matmul.ops.matmul(a, b, engine=eng) at yi-9b's full-width layer
   GEMMs (a 16 x 1024 prefill wave and a decode step through q/o, k+v,
   gate/up and down, the LM head, one fp32 case), every mode x rinse,
   launches of both schedules (accumulating and split-K) counted; then for
   each distinct schedule the kernel against its plain version, mnk == nmk
   bitwise, its time beside the plan's modeled time, the plain version,
   torch.matmul and the bound, and per shape the fastest mode on the card.

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
    "ssd": "src/repro_torch/kernels/ssd/csrc/ssd.cu",
    "moe_gmm": "src/repro_torch/kernels/moe_gmm/csrc/moe_gmm.cu",
    "matmul": "src/repro_torch/kernels/matmul/csrc/matmul.cu",
}
TPU_SITES = {
    "paged_decode_attention":
        "src/repro/kernels/decode_attention/decode_attention.py:274",
    "decode_attention":
        "src/repro/kernels/decode_attention/decode_attention.py:106",
    "flash_attention": "src/repro/kernels/flash_attention/flash_attention.py:129",
    "fused_norm": "src/repro/kernels/fused_norm/fused_norm.py:73",
    "ssd": "src/repro/kernels/ssd/ssd.py:110",
    "grouped_matmul": "src/repro/kernels/moe_gmm/moe_gmm.py:78",
    "matmul": "src/repro/kernels/matmul/matmul.py:126",
    "matmul(split_k>1)": "src/repro/kernels/matmul/matmul.py:98",
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

def _pool_case(gen, dtype, lengths, n_table, n_pages, hq=HQ, hkv=HKV, d=D):
    """Random q and pools, and page tables mapping distinct pages (a
    seeded permutation) up to each slot's length, -1 beyond."""
    b = lengths.shape[0]
    q = torch.randn(b, hq, d, generator=gen, device="cuda").to(dtype)
    kp = torch.randn(n_pages, PSZ, hkv, d, generator=gen, device="cuda").to(dtype)
    vp = torch.randn(n_pages, PSZ, hkv, d, generator=gen, device="cuda").to(dtype)
    perm = torch.randperm(n_pages, generator=gen, device="cuda")
    pages = perm[: b * n_table].reshape(b, n_table).to(torch.int32)
    mapped = (lengths.long() + PSZ - 1) // PSZ
    cols = torch.arange(n_table, device="cuda")[None, :]
    pages = torch.where(cols < mapped[:, None], pages, -1).contiguous()
    return q, kp, vp, pages


def _bound(dtype, lengths, b, n_mapped, hq=HQ, hkv=HKV, d=D):
    """Least time for one call: bytes each input read once and the output
    written once, against operations at the input type's peak."""
    esize = torch.empty((), dtype=dtype).element_size()
    tokens = int(lengths.sum())
    nbytes = (2 * tokens * hkv * d * esize          # valid K and V
              + b * hq * d * esize * 2              # q in, out written
              + 4 * (n_mapped + b))                 # page entries, lengths
    ops = 4 * tokens * hq * d                       # QK^T and PV
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def planned_splits(hq: int, hkv: int, d: int, bkv: int = PSZ) -> int:
    """The decode kernels' split count the serve engine bakes at SLOTS x
    MAX_LEN: the policy engine's (H100 model) decode plan, one split per
    planned KV block, over ``bkv``-wide kernel blocks."""
    from repro_torch.core import make_engine
    from repro_torch.core.characterize import attention_op
    from repro_torch.kernels.decode_attention.ops import plan_splits

    plan = make_engine(chip="h100").plan_op(attention_op(
        SLOTS, hq, hkv, 1, MAX_LEN, d, causal=False, name="serve_decode"))
    return plan_splits(MAX_LEN, bkv, plan=plan)


def phase_kernels(gpu: str, seed: int) -> dict:
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention import decode_attention as dk
    from repro_torch.kernels.decode_attention import ref
    from repro_torch.models.common import gather_pages

    gen = torch.Generator(device="cuda").manual_seed(seed)
    n_table = MAX_LEN // PSZ
    n_pages = SLOTS * n_table
    planned = planned_splits(HQ, HKV, D)
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
            for splits in sorted({1, planned, 8}):
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
    splits = planned_splits(HQ, HKV, D, bkv=512)
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
          "planned_splits": planned, "ring_splits": splits,
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
# Phase 6: the SSD scan; phase 7: attention at zamba2's shapes
# ---------------------------------------------------------------------------

# (name, b, l, h, dh, g, ds): the two models' prefill shapes at the serve
# traffic's widest bucket, and a grouped case with a ragged length.
SSD_CASES = (("mamba2", SLOTS, PREFILL_PAD, 64, 64, 1, 128),
             ("zamba2", SLOTS, PREFILL_PAD, 80, 64, 1, 64),
             ("grouped", 4, 300, 8, 64, 2, 64))


def _ssd_inputs(gen, dtype, b, l, h, dh, g, ds):
    """Inputs shaped as the model makes them: x, B and C strided views of
    one conv output, dt softplus'ed, A from the init's range, a nonzero
    initial state; slot 1 parked (dt = 0), the other odd slots with a
    ragged dt-zero tail."""
    xbc = torch.randn(b, l, h * dh + 2 * g * ds, generator=gen,
                      device="cuda").to(dtype)
    di = h * dh
    x = xbc[..., :di].reshape(b, l, h, dh)
    B = xbc[..., di:di + g * ds].reshape(b, l, g, ds)
    C = xbc[..., di + g * ds:].reshape(b, l, g, ds)
    dt = torch.nn.functional.softplus(
        torch.randn(b, l, h, generator=gen, device="cuda") - 1.0)
    tails = torch.randint(1, l + 1, (b,), generator=gen, device="cuda")
    keep = torch.arange(l, device="cuda")[None, :] < tails[:, None]
    keep[::2] = True
    keep[1] = False
    dt = dt * keep[..., None]
    A = -torch.linspace(1.0, 16.0, h, device="cuda")
    D = torch.randn(h, generator=gen, device="cuda")
    S0 = torch.randn(b, h, ds, dh, generator=gen, device="cuda")
    return x, dt, A, B, C, D, S0


def _ssd_bound(dtype, b, l, h, dh, g, ds):
    """Least time for one scan: x and B, C, dt read and y written once,
    the state read and written once (fp32), against the flops of the
    chunked algorithm at the kernel's 64-row tile (C B^T, the causal half
    of M x, C S and the state update) at the input type's peak."""
    es, q = _esize(dtype), 64
    nbytes = (2 * b * l * h * dh * es + 2 * b * l * g * ds * es
              + 4 * b * l * h + 8 * h + 2 * 4 * b * h * ds * dh)
    nc = -(-l // q)
    ops = b * h * nc * (2 * q * q * ds + q * (q + 1) * dh + 4 * q * ds * dh)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", ops / 1e9)


def phase_ssd(gpu: str, seed: int) -> dict:
    """The SSD kernel against its plain version (the reference's chunk
    rule), bf16 and fp32; parked slots' states bitwise; timed (bf16 and
    fp32 at the models' shapes) beside the bound."""
    from repro_torch.kernels.ssd import ssd as sk

    gen = torch.Generator(device="cuda").manual_seed(seed + 30)
    rows, err, main = [], 0.0, {}
    for name, b, l, h, dh, g, ds in SSD_CASES:
        for dtype in (torch.bfloat16, torch.float32):
            x, dt, A, B, C, D, S0 = _ssd_inputs(gen, dtype, b, l, h, dh, g, ds)
            chunk = min(max(128, l // 16), 1024)

            def kernel():
                return sk.ssd_cuda(x, dt, A, B, C, D, init_state=S0)

            def plain():
                return sk.ssd_plain(x, dt, A, B, C, D, chunk=chunk,
                                    init_state=S0)

            (y, S), (yp, Sp) = kernel(), plain()
            torch.cuda.synchronize()
            tag = f"ssd {name} {dtype}"
            e = max(check_close(tag + " y", y, yp, dtype),
                    check_close(tag + " state", S, Sp, torch.float32))
            check_equal(tag + " parked state", S[1], S0[1])
            err = max(err, e)
            bound_ms, bound_by, gflop = _ssd_bound(dtype, b, l, h, dh, g, ds)
            row = {"case": name, "dtype": str(dtype).removeprefix("torch."),
                   "shape": [b, l, h, dh, g, ds], "err": e,
                   "parked_state_bitwise": True, "bound_ms": bound_ms,
                   "bound_by": bound_by, "gflop": gflop, "library_ms": None}
            if name != "grouped":
                row |= {"ms": time_ms(kernel), "plain_ms": time_ms(plain,
                                                                   reps=5)}
            rows.append(row)
            if name == "mamba2" and dtype == torch.bfloat16:
                main = row
            del x, dt, B, C, S0, y, S, yp, Sp
    emit({"phase": "kernels_ssd", "gpu": gpu, "rows": rows,
          "kernel_chunk": sk.KERNEL_CHUNK,
          "smem_bytes": {"mamba2": sk.smem_bytes(64, 128),
                         "zamba2": sk.smem_bytes(64, 64)}})
    return {"main": main, "err": err}


def phase_attn_zamba2(gpu: str, seed: int) -> dict:
    """Decode and flash attention at zamba2-2.7b's shared block: 32 query
    and 32 KV heads (group 1), head dim 80.  Decode over a paged pool of
    16 slots x 2048 positions (paged == dense bitwise), flash at 16 x 1024
    causal, each against its plain version and timed beside SDPA."""
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention import decode_attention as dk
    from repro_torch.kernels.flash_attention import flash_attention as fk
    from repro_torch.models.common import gather_pages

    hq = hkv = 32
    d = 80
    gen = torch.Generator(device="cuda").manual_seed(seed + 40)
    n_table = MAX_LEN // PSZ
    rows, out = [], {"decode_err": 0.0, "flash_err": 0.0}
    splits = planned_splits(hq, hkv, d)
    for dtype in (torch.bfloat16, torch.float32):
        lengths = torch.full((SLOTS,), MAX_LEN, dtype=torch.int32,
                             device="cuda")
        q, kp, vp, pages = _pool_case(gen, dtype, lengths, n_table,
                                      SLOTS * n_table, hq=hq, hkv=hkv, d=d)
        kd = gather_pages(kp, pages).transpose(1, 2)
        vd = gather_pages(vp, pages).transpose(1, 2)

        def paged():
            return dk.paged_decode_attention_cuda(q, kp, vp, pages, lengths,
                                                  splits=splits)

        def dense():
            return dk.decode_attention_cuda(q, kd, vd, lengths, bkv=PSZ,
                                            splits=splits)

        def plain():
            return dk.paged_decode_attention_plain(q, kp, vp, pages, lengths,
                                                   splits=splits)

        kdc, vdc = kd.contiguous(), vd.contiguous()

        def library():
            return F.scaled_dot_product_attention(q[:, :, None], kdc, vdc)

        out_p, out_d, want = paged(), dense(), plain()
        torch.cuda.synchronize()
        e = check_close(f"decode d80 {dtype}", out_p, want, dtype)
        check_equal(f"decode d80 paged == dense {dtype}", out_p, out_d)
        out["decode_err"] = max(out["decode_err"], e)
        bound_ms, bound_by = _bound(dtype, lengths, SLOTS,
                                    int((pages >= 0).sum()), hq, hkv, d)
        row = {"kernel": "decode", "dtype": str(dtype).removeprefix("torch."),
               "shape": [SLOTS, hq, hkv, MAX_LEN, d], "splits": splits,
               "err": e, "paged_equals_dense": True,
               "ms": time_ms(paged), "dense_ms": time_ms(dense),
               "plain_ms": time_ms(plain), "library_ms": time_ms(library),
               "bound_ms": bound_ms, "bound_by": bound_by}
        rows.append(row)
        if dtype == torch.bfloat16:
            out["decode"] = row
        del q, kp, vp, kd, vd, kdc, vdc
        sq = PREFILL_PAD
        q, k, v = (torch.randn(SLOTS, h, sq, d, generator=gen,
                               device="cuda").to(dtype)
                   for h in (hq, hkv, hkv))

        def fkernel():
            return fk.flash_attention_cuda(q, k, v, causal=True)

        def fplain():
            return fk.flash_attention_plain(q, k, v, causal=True)

        def flibrary():
            return F.scaled_dot_product_attention(q, k, v, is_causal=True)

        got, want = fkernel(), fplain()
        torch.cuda.synchronize()
        e = check_close(f"flash d80 {dtype}", got, want, dtype)
        out["flash_err"] = max(out["flash_err"], e)
        full = torch.full((SLOTS,), sq, dtype=torch.int32)
        need, pairs = _flash_work(torch.zeros(SLOTS), full, full)
        bound_ms, bound_by = _flash_bound(dtype, full, need, pairs, SLOTS, sq,
                                          hq, hkv, d)
        row = {"kernel": "flash", "dtype": str(dtype).removeprefix("torch."),
               "shape": [SLOTS, hq, hkv, sq, sq, d], "causal": True, "err": e,
               "ms": time_ms(fkernel), "plain_ms": time_ms(fplain, reps=5),
               "library_ms": time_ms(flibrary), "bound_ms": bound_ms,
               "bound_by": bound_by}
        rows.append(row)
        if dtype == torch.bfloat16:
            out["flash"] = row
        del q, k, v, got, want
    emit({"phase": "kernels_attn_zamba2", "gpu": gpu, "rows": rows})
    return out


# ---------------------------------------------------------------------------
# Phase 11: the MoE grouped GEMM
# ---------------------------------------------------------------------------

# (name, e, c, k, n, with counts): olmoe-1b-7b's expert products (64
# experts, d 2048, d_ff 1024) at the serve path's shapes: a dense-dispatch
# prefill wave (every expert multiplies all 16 x 1024 tokens) through
# wg/wu and through wd, a decode step (16 tokens), a sorted-dispatch
# wave's capacity buffers (16384 x 8 x 1.25 / 64 = 2560 rows an expert)
# with counts, the reference test's ragged shape and a ragged k.
GMM_CASES = (("prefill", 64, 16384, 2048, 1024, False),
             ("prefill_wd", 64, 16384, 1024, 2048, False),
             ("decode", 64, 16, 2048, 1024, False),
             ("decode_wd", 64, 16, 1024, 2048, False),
             ("sorted", 64, 2560, 2048, 1024, True),
             ("ragged", 8, 100, 200, 130, True),
             ("ragged_k", 5, 77, 130, 96, True))


def phase_gmm(gpu: str, seed: int) -> dict:
    """The grouped GEMM against its plain version, bf16 and fp32, at
    olmoe's shapes; rows past each count exactly 0; timed beside its
    bound, the plain version and torch.bmm."""
    from repro_torch.kernels.moe_gmm import moe_gmm as gk

    gen = torch.Generator(device="cuda").manual_seed(seed + 50)
    rows, err, main = [], 0.0, None
    for name, e, c, k, n, with_counts in GMM_CASES:
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.randn(e, c, k, generator=gen, device="cuda").to(dtype)
            w = (torch.randn(e, k, n, generator=gen, device="cuda")
                 * k ** -0.5).to(dtype)
            counts = None
            if with_counts:
                counts = torch.randint(0, c + 1, (e,), generator=gen,
                                       device="cuda", dtype=torch.int32)
                counts[0], counts[1] = 0, c

            def kernel():
                return gk.grouped_matmul_cuda(x, w, counts)

            def plain():
                return gk.grouped_matmul_plain(x, w, counts)

            def library():
                return torch.bmm(x, w)

            got, want = kernel(), plain()
            torch.cuda.synchronize()
            tag = f"gmm {name} {dtype}"
            e_k = check_close(tag, got, want, dtype)
            live = (torch.full((e,), c, device="cuda") if counts is None
                    else counts.clamp(0, c)).long()
            if counts is not None:
                dead = (torch.arange(c, device="cuda")[None, :]
                        >= live[:, None])
                if bool(got[dead].float().abs().max() != 0):
                    raise AssertionError(f"{tag}: rows past the counts are "
                                         "not exactly 0")
            lib_err = (library().float() - want.float())
            if counts is not None:
                lib_err = lib_err[~dead]
            lib_err = lib_err.abs().max().item()
            del got, want
            err = max(err, e_k)
            es = _esize(dtype)
            n_rows = int(live.sum())
            nbytes = (n_rows * k * es + int((live > 0).sum()) * k * n * es
                      + e * c * n * es + (4 * e if counts is not None else 0))
            ops = 2 * n_rows * k * n
            t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS[dtype]
            big = c * k * n * e > 1e11 and dtype == torch.float32
            timing = dict(reps=3, warm=1) if big else {}
            row = {"case": name, "dtype": str(dtype).removeprefix("torch."),
                   "shape": [e, c, k, n],
                   "counts": None if counts is None else counts.tolist(),
                   "err": e_k, "library_err": lib_err,
                   "rows_past_counts_zero": counts is not None,
                   "ms": time_ms(kernel, **timing),
                   "plain_ms": time_ms(plain, reps=3, warm=1),
                   "library_ms": time_ms(library, **timing),
                   "bound_ms": max(t_bytes, t_ops) * 1e3,
                   "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                   "gflop": ops / 1e9}
            row["tflop_per_s"] = ops / row["ms"] / 1e9
            rows.append(row)
            if dtype == torch.bfloat16 and name == "prefill":
                main = row
            del x, w, counts
            torch.cuda.empty_cache()
    emit({"phase": "kernels_gmm", "gpu": gpu, "rows": rows})
    return {"main": main, "err": err}


# ---------------------------------------------------------------------------
# Phase 14: the policy-planned matmul
# ---------------------------------------------------------------------------

# (name, m, k, n, dtype): yi-9b's layer GEMMs at full width (d 4096, k+v
# 2 x 4 x 128, d_ff 11008, vocab 65536 padded) for a 16 x 1024 prefill
# wave and a 16-slot decode step, and one fp32 case.
MM_SHAPES = (("prefill_qo", 16384, 4096, 4096, torch.bfloat16),
             ("prefill_kv", 16384, 4096, 1024, torch.bfloat16),
             ("prefill_gate_up", 16384, 4096, 11008, torch.bfloat16),
             ("prefill_down", 16384, 11008, 4096, torch.bfloat16),
             ("decode_qo", 16, 4096, 4096, torch.bfloat16),
             ("decode_kv", 16, 4096, 1024, torch.bfloat16),
             ("decode_gate_up", 16, 4096, 11008, torch.bfloat16),
             ("decode_down", 16, 11008, 4096, torch.bfloat16),
             ("lm_head", 16, 4096, 65536, torch.bfloat16),
             ("prefill_qo_fp32", 16384, 4096, 4096, torch.float32))
MM_MODES = tuple((mode, rinse) for mode in ("uncached", "cacher", "cacherw",
                                            "adaptive")
                 for rinse in (True, False))


def _mm_inputs(seed: int, i: int, m: int, k: int, n: int, dtype):
    gen = torch.Generator(device="cuda").manual_seed(seed + 60 + i)
    a = torch.randn(m, k, generator=gen, device="cuda").to(dtype)
    b = (torch.randn(k, n, generator=gen, device="cuda")
         * k ** -0.5).to(dtype)
    return a, b


def _mm_key(schedule) -> tuple:
    """The kernel's resolved schedule; the split path ignores the order."""
    order = schedule["order"] if schedule["split_k"] == 1 else "-"
    return (schedule["bm"], schedule["bn"], schedule["bk"], order,
            schedule["split_k"])


def phase_policy_matmul(gpu: str, seed: int) -> dict:
    """The cache-policy core's main path on the card: every mode x rinse
    engine (H100 model) plans each GEMM and ``ops.matmul(a, b,
    engine=eng)`` runs it, counters zeroed just before and read just
    after, each output held against the plain version.  Then for each
    distinct schedule: mnk == nmk and a repeat bitwise, the kernel's time
    (the split schedule's includes the partials' sum) beside the plan's
    modeled time, the plain version, torch.matmul and the bound."""
    from repro_torch.core import make_engine
    from repro_torch.core.characterize import matmul_op
    from repro_torch.device import dtype_name
    from repro_torch.kernels.matmul import matmul as mk
    from repro_torch.kernels.matmul import ops

    torch.backends.cuda.matmul.allow_tf32 = False    # fp32 yardstick in fp32
    t0 = time.perf_counter()
    engines = {mr: make_engine(mr[0], rinse=mr[1], chip="h100")
               for mr in MM_MODES}
    plans, errs = {}, {"accumulate": 0.0, "split": 0.0}
    reset_counts()                          # the planned-GEMM main path
    for i, (name, m, k, n, dtype) in enumerate(MM_SHAPES):
        a, b = _mm_inputs(seed, i, m, k, n, dtype)
        want = {}
        for mr, eng in engines.items():
            plan, schedule = ops.resolve_schedule(
                m, k, n, dtype_name(dtype), engine=eng)
            got = ops.matmul(a, b, engine=eng)
            pkey = (schedule["bk"], schedule["split_k"])
            if pkey not in want:
                want[pkey] = mk.matmul_plain(a, b, bk=schedule["bk"],
                                             split_k=schedule["split_k"])
            route = "split" if schedule["split_k"] > 1 else "accumulate"
            errs[route] = max(errs[route], check_close(
                f"matmul {name} {mr}", got, want[pkey], dtype))
            plans[name, mr] = (plan, schedule)
            del got
        del a, b, want
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    launches = counts()
    main_s = time.perf_counter() - t0
    if launches["matmul"] == 0 or launches["matmul_split"] == 0:
        raise AssertionError(f"policy_matmul: a schedule was never "
                             f"launched: {launches}")

    rows, summary = [], []
    for i, (name, m, k, n, dtype) in enumerate(MM_SHAPES):
        a, b = _mm_inputs(seed, i, m, k, n, dtype)
        es = _esize(dtype)
        t_bytes = (m * k + k * n + m * n) * es / HBM_BYTES_PER_S
        t_ops = 2 * m * n * k / PEAK_OPS[dtype]
        bound = {"bound_ms": max(t_bytes, t_ops) * 1e3,
                 "bound_by": "bytes" if t_bytes >= t_ops else "operations"}

        def library():
            return torch.matmul(a, b)

        library_ms = time_ms(library)
        measured, plain_ms = {}, {}
        for mr in MM_MODES:
            plan, schedule = plans[name, mr]
            key = _mm_key(schedule)
            if key not in measured:
                def kernel(order=schedule["order"]):
                    return mk.matmul_cuda(a, b, **{**schedule,
                                                   "order": order})

                flip = "nmk" if schedule["order"] == "mnk" else "mnk"
                first, other, again = kernel(), kernel(flip), kernel()
                torch.cuda.synchronize()
                check_equal(f"matmul {name} {key} mnk == nmk", first, other)
                check_equal(f"matmul {name} {key} repeat", first, again)
                pkey = (schedule["bk"], schedule["split_k"])
                if pkey not in plain_ms:
                    plain_ms[pkey] = time_ms(
                        lambda: mk.matmul_plain(a, b, bk=pkey[0],
                                                split_k=pkey[1]),
                        reps=3, warm=1)
                del first, other, again
                measured[key] = {"ms": time_ms(kernel),
                                 "plain_ms": plain_ms[pkey]}
            eng = engines[mr]
            op = matmul_op(m, k, n, dtype=dtype_name(dtype))
            rows.append({
                "shape": name, "mnk": [m, n, k],
                "dtype": str(dtype).removeprefix("torch."),
                "mode": mr[0], "rinse": mr[1],
                "out": plan.policy("out").value,
                "assignment": {o: v.value for o, v in
                               plan.assignment.items()},
                "window": [schedule["bm"], schedule["bn"]],
                "bk": schedule["bk"], "order": schedule["order"],
                "split_k": schedule["split_k"],
                "splits_run": (mk.split_ranges(k, schedule["bk"],
                                               schedule["split_k"])[1]
                               if schedule["split_k"] > 1 else 1),
                "modeled_ms": eng.cost(op, plan).t_total * 1e3,
                **measured[key], "library_ms": library_ms, **bound})
        shape_rows = rows[-len(MM_MODES):]
        fastest = min(shape_rows, key=lambda r: r["ms"])
        adaptive = next(r for r in shape_rows
                        if r["mode"] == "adaptive" and r["rinse"])
        summary.append({
            "shape": name, "fastest_mode": [fastest["mode"],
                                            fastest["rinse"]],
            "fastest_ms": fastest["ms"], "adaptive_ms": adaptive["ms"],
            "adaptive_over_fastest": adaptive["ms"] / fastest["ms"],
            "schedules": len(measured), "library_ms": library_ms,
            **bound})
        del a, b
        torch.cuda.empty_cache()
    emit({"phase": "policy_matmul", "gpu": gpu, "launch_counts": launches,
          "main_path_s": main_s, "phase_s": time.perf_counter() - t0,
          "tf32": torch.backends.cuda.matmul.allow_tf32,
          "cta_tile": {str(t).removeprefix("torch."): v
                       for t, v in mk.CTA_TILE.items()},
          "rows": rows})
    emit({"phase": "policy_matmul_summary", "gpu": gpu, "shapes": summary})

    def main_row(out):
        return next(r for r in rows if r["shape"] == "prefill_qo"
                    and r["out"] == out)

    return {"launches": launches, "errs": errs,
            "accumulate": main_row("resident_accum"),
            "split": main_row("stream")}


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
    stats = eng.serve_stats() | {"paged": eng.paged,
                                 "decode_splits": eng.decode_splits}
    held = (eng.n_pages - eng.allocator.free_count()) if eng.paged else 0
    del eng
    return wall, chunk_s, stats, held


def _kernel_modules():
    from repro_torch.kernels.decode_attention import decode_attention as dk
    from repro_torch.kernels.flash_attention import flash_attention as fk
    from repro_torch.kernels.fused_norm import fused_norm as nk
    from repro_torch.kernels.matmul import matmul as mk
    from repro_torch.kernels.moe_gmm import moe_gmm as gk
    from repro_torch.kernels.ssd import ssd as sk

    return dk, fk, nk, sk, gk, mk


def reset_counts() -> None:
    """Zero every kernel's launch and plain-call counters."""
    for mod in _kernel_modules():
        mod.reset_counters()


def counts() -> dict:
    dk, fk, nk, sk, gk, mk = _kernel_modules()
    return {"decode_paged": dk.paged_decode_attention.launches,
            "decode_dense": dk.decode_attention.launches,
            "flash_paged": fk.paged_flash_attention.launches,
            "flash_dense": fk.flash_attention.launches,
            "fused_norm": nk.fused_norm.launches,
            "ssd": sk.ssd.launches,
            "grouped_matmul": gk.grouped_matmul.launches,
            "matmul": mk.matmul.launches,
            "matmul_split": mk.matmul.splitk_launches,
            "plain": (dk.paged_decode_attention_plain.calls
                      + dk.decode_attention_plain.calls
                      + fk.paged_flash_attention_plain.calls
                      + fk.flash_attention_plain.calls
                      + nk.fused_norm_plain.calls + sk.ssd_plain.calls
                      + gk.grouped_matmul_plain.calls
                      + mk.matmul_plain.calls)}


def check_counts(arm: str, got: dict, cfg, stats: dict) -> None:
    """Every prefill launches one flash kernel per attention layer and one
    SSD kernel per Mamba-2 layer, every decode step one decode kernel per
    attention layer, both one fused norm per norm (two per attention
    block, one per Mamba-2 layer, plus the final one) and three grouped
    GEMMs per MoE layer; no serve path calls the planned matmul, and
    nothing takes a plain version.  Attention layers:
    all of a dense or MoE model's, the shared block's invocations of
    zamba2, none of mamba2's."""
    L, steps = cfg.n_layers, stats["chunks"] * 8
    waves = stats["admission_waves"]
    attn, ssm = {"dense": (L, 0), "moe": (L, 0), "ssm": (0, L),
                 "hybrid": (L // max(cfg.shared_attn_every, 1), L)}[cfg.family]
    moe = L if cfg.family == "moe" else 0
    paged = cfg.decode_kernel == "pallas_paged"
    want = {"decode_paged": attn * steps if paged else 0,
            "decode_dense": 0 if paged else attn * steps,
            "flash_paged": attn * waves if paged else 0,
            "flash_dense": 0 if paged else attn * waves,
            "fused_norm": (2 * attn + ssm + 1) * (waves + steps),
            "ssd": ssm * waves,
            "grouped_matmul": 3 * moe * (waves + steps), "matmul": 0,
            "matmul_split": 0, "plain": 0}
    if got != want:
        raise AssertionError(f"{arm} arm: launch counts {got} != {want}")


def check_streams(arm: str, reqs, cfg) -> None:
    for r in reqs:
        if len(r.generated) != r.max_new_tokens or not all(
                0 <= t < cfg.padded_vocab for t in r.generated):
            raise AssertionError(f"{arm} arm: request {r.id}: bad stream")


def phase_serve(gpu: str, seed: int, cfg, name: str = "serve") -> dict:
    """Serve the 48 requests at ``cfg`` (a paged pallas_paged config) with
    every launch count checked; for a model with attention, then the first
    16 requests under pallas_gather (streams bitwise equal) and the
    decode-chunk and admission-wave trace."""
    from repro_torch import convert
    from repro_torch.serve.engine import Request

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
    check_counts(name, counts_paged, cfg, stats)
    check_streams(name, reqs, cfg)
    if cfg.n_heads and stats["decode_splits"] != planned_splits(
            cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_):
        raise AssertionError(f"{name}: the engine baked "
                             f"{stats['decode_splits']} decode splits, not "
                             "its policy engine's plan")
    tokens = sum(len(r.generated) for r in reqs)
    peak = torch.cuda.max_memory_allocated()
    line = {
        "phase": name, "gpu": gpu, "arch": cfg.arch,
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
        "engine_paged": stats["paged"],
        "decode_splits": stats["decode_splits"],
        "peak_pages_held": stats["peak_pages_held"],
        "max_memory_allocated": peak, "launch_counts": counts_paged,
    }
    out = {"cfg": cfg, "params": params, "launches": counts_paged,
           "reqs": reqs}
    if cfg.family == "ssm":
        if stats["paged"]:
            raise AssertionError(f"{name}: a cache with no pages must run "
                                 "contiguous bookkeeping")
        emit(line)
        return out

    # The bitwise twin over the first 16 requests (the first wave's): each
    # slot's arithmetic does not depend on what the other slots hold.
    gcfg = dataclasses.replace(cfg, decode_kernel="pallas_gather")
    greqs = _requests(Request, cfg.vocab, seed)[:SLOTS]
    reset_counts()                              # the pallas_gather path
    gwall, gchunk_s, gstats, _ = _serve(gcfg, params, greqs)
    counts_gather = counts()
    check_counts(name + " gather", counts_gather, gcfg, gstats)
    if [r.generated for r in greqs] != [r.generated for r in reqs[:SLOTS]]:
        raise AssertionError(f"{name}: pallas_gather streams differ from "
                             "pallas_paged")
    gtokens = sum(len(r.generated) for r in greqs)
    line["gather"] = {"requests": len(greqs), "tokens": gtokens,
                      "wall_s": gwall, "tok_per_s": gtokens / gwall,
                      "ms_per_chunk": 1e3 * statistics.mean(gchunk_s),
                      "launch_counts": counts_gather, "streams_equal": True}
    emit(line)
    phase_trace(gpu, cfg, params, seed)
    return out | {"gather_launches": counts_gather}


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
    emit({"phase": "trace", "gpu": gpu, "arch": cfg.arch, "chunk_steps": 8,
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


def phase_preempt(gpu: str, seed: int, cfg, params, unpressured) -> None:
    """The serve arm's 48 requests on a 256-page pool (below the 16 slots'
    worst case of up to 72 pages a request), preemption on and invariants
    checked after every wave; recurrent state is rebuilt by the recompute
    restore.  Streams and first tokens equal to the unpressured run's are
    reported, not required: restore prefills run at other bf16 shapes."""
    from repro_torch.serve.engine import Request

    pcfg = dataclasses.replace(cfg, preemption=True, strict_invariants=True)
    reqs = _requests(Request, cfg.vocab, seed)
    reset_counts()                              # the preemption arm
    wall, chunk_s, stats, held = _serve(pcfg, params, reqs,
                                        n_pages=PREFIX_POOL)
    got = counts()
    check_counts("preempt", got, pcfg, stats)
    check_streams("preempt", reqs, pcfg)
    if stats["preempted"] <= 0:
        raise AssertionError("preempt arm: no preemption on a short pool")
    if held:
        raise AssertionError(f"preempt arm: {held} pages held after drain")
    if stats["invariant_checks"] < stats["admission_waves"]:
        raise AssertionError("preempt arm: invariants not checked every wave")
    tokens = sum(len(r.generated) for r in reqs)
    emit({"phase": "preempt_" + cfg.arch.split("-")[0], "gpu": gpu,
          "arch": cfg.arch, "n_layers": cfg.n_layers, "dtype": cfg.dtype,
          "requests": len(reqs), "pool_pages": PREFIX_POOL,
          "tokens": tokens, "wall_s": wall, "tok_per_s": tokens / wall,
          "mean_ttft_ms": 1e3 * statistics.mean(r.ttft_s for r in reqs),
          "ms_per_chunk": 1e3 * statistics.mean(chunk_s),
          "preempted": stats["preempted"],
          "readmitted": stats["readmitted"],
          "recompute_tokens": stats["recompute_tokens"],
          "admission_waves": stats["admission_waves"],
          "invariant_checks": stats["invariant_checks"],
          "peak_pages_held": stats["peak_pages_held"],
          "pages_held_after_drain": held, "launch_counts": got,
          "streams_equal_unpressured": sum(
              a.generated == b.generated for a, b in zip(reqs, unpressured)),
          "first_tokens_equal_unpressured": sum(
              a.generated[0] == b.generated[0]
              for a, b in zip(reqs, unpressured))})


# ---------------------------------------------------------------------------
# Phase 5: kernel path against the plain path, end to end
# ---------------------------------------------------------------------------

def phase_e2e(gpu: str, seed: int, base, want=None,
              compare: str = "pallas_paged vs xla",
              ragged: bool = True) -> None:
    """The kernel route (pallas_paged) on ``base``, an fp32 config cut in
    depth, against ``want`` (default: the plain route, xla, of the same
    config): a ragged prefill (``ragged`` False: every row valid), 4
    decode steps with a slot parking every other step, and a continuation
    prefill at nonzero cursors with one slot parked, logits within 2e-3.

    Padding rows are garbage by contract, and the two routes' garbage
    differs (the flash kernel writes zeros there, the plain path
    attends).  Under sorted MoE dispatch those rows contend for expert
    capacity, so two routes can drop different real tokens: the sorted
    kernel-vs-plain check prefills without padding (``ragged`` False).
    Its later blocks (4 and 128 tokens) cannot overflow the 128-row
    capacity floor."""
    from repro_torch import convert
    from repro_torch.models import build_model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    params = convert.init(base, gen, "cuda")
    b, max_len = 4, 256
    rng = np.random.default_rng(seed)
    seg = torch.tensor([100, 37, 64, 5] if ragged else [128] * 4,
                       dtype=torch.int32, device="cuda")
    toks = torch.from_numpy(
        rng.integers(0, base.vocab, size=(b, 128)).astype(np.int32)).to("cuda")
    errs = []
    with torch.inference_mode():
        models, caches = {}, {}
        arms = {"got": dataclasses.replace(base, decode_kernel="pallas_paged"),
                "want": want or dataclasses.replace(base,
                                                    decode_kernel="xla")}
        for arm, cfg in arms.items():
            m = build_model(cfg, "cuda")
            c = m.init_cache(params, batch=b, max_len=max_len)
            if "pages" in c:
                c["pages"] = torch.arange(
                    c["pages"].numel(), dtype=torch.int32,
                    device="cuda").reshape(c["pages"].shape)
            models[arm], caches[arm] = m, c
        logits = {}
        for arm, m in models.items():
            logits[arm], caches[arm] = m.prefill(params, caches[arm], toks,
                                                   seg_lens=seg)
        errs.append(check_close("e2e prefill", logits["got"],
                                logits["want"], torch.float32))
        for step in range(4):
            nxt = logits["want"][:, -1].argmax(-1).to(torch.int32)[:, None]
            active = torch.tensor([1, 1, step % 2, 1], dtype=torch.int32,
                                  device="cuda")
            for arm, m in models.items():
                logits[arm], caches[arm] = m.decode_step(
                    params, caches[arm], nxt, seg_lens=active)
            errs.append(check_close(f"e2e decode {step}",
                                    logits["got"], logits["want"],
                                    torch.float32))
        # A continuation prefill at each slot's nonzero cursor (the flash
        # kernel's q_offset case), slot 1 parked: a parked slot's logits
        # are garbage by contract (the kernel gives its rows zeros, the
        # plain path attends), so only the others are compared.
        more = torch.from_numpy(rng.integers(
            0, base.vocab, size=(b, 32)).astype(np.int32)).to("cuda")
        seg2 = torch.tensor([32, 0, 17, 9], dtype=torch.int32,
                            device="cuda")
        for arm, m in models.items():
            logits[arm], caches[arm] = m.prefill(params, caches[arm],
                                                   more, seg_lens=seg2)
        live = seg2 > 0
        errs.append(check_close("e2e continuation prefill",
                                logits["got"][live],
                                logits["want"][live], torch.float32))
        check_equal("e2e cursors", caches["got"]["lengths"],
                    caches["want"]["lengths"])
        if "ssm" in caches["want"]:
            errs.append(check_close("e2e ssm state",
                                    caches["got"]["ssm"],
                                    caches["want"]["ssm"], torch.float32))
    emit({"phase": "e2e", "gpu": gpu, "arch": base.arch, "compare": compare,
          "n_layers": base.n_layers, "cache_layout": base.cache_layout,
          "ragged_prefill": ragged,
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
    from repro_torch.configs import mamba2_13b, olmoe_1b_7b, yi_9b, zamba2_27b

    from repro_torch import hw

    gpu = card_line()
    props = torch.cuda.get_device_properties(0)
    emit({"phase": "card", "gpu": gpu, "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "device": {"sms": props.multi_processor_count,
                     "total_memory": props.total_memory,
                     "l2_cache_size": props.L2_cache_size},
          "h100_model": {"hbm_bytes": hw.H100.hbm_bytes,
                         "hbm_bw": hw.H100.hbm_bw,
                         "residency_bytes": hw.H100.vmem_bytes,
                         "residency_budget": hw.H100.vmem_budget,
                         "peak_flops_bf16": hw.H100.peak_flops_bf16,
                         "peak_flops_fp32": hw.H100.peak_flops_fp32},
          "build_s": build_kernels()})
    kern = phase_kernels(gpu, args.seed)
    flash = phase_flash(gpu, args.seed)
    norm = phase_norm(gpu, args.seed)
    ssd = phase_ssd(gpu, args.seed)
    phase_attn_zamba2(gpu, args.seed)
    gmm = phase_gmm(gpu, args.seed)
    mm = phase_policy_matmul(gpu, args.seed)
    served = {}                 # each main path's launch counts
    paged = dict(cache_layout="paged", kv_page_size=PSZ,
                 decode_kernel="pallas_paged")
    serve = phase_serve(gpu, args.seed,
                        dataclasses.replace(yi_9b.CONFIG, **paged))
    phase_prefix(gpu, args.seed, serve["cfg"], serve["params"])
    served["yi-9b"] = serve
    del serve["params"]
    torch.cuda.empty_cache()
    zserve = phase_serve(gpu, args.seed,
                         dataclasses.replace(zamba2_27b.CONFIG, **paged),
                         "serve_zamba2")
    phase_preempt(gpu, args.seed, zserve["cfg"], zserve["params"],
                  zserve["reqs"])
    served["zamba2-2.7b"] = zserve
    del zserve["params"]
    torch.cuda.empty_cache()
    mserve = phase_serve(gpu, args.seed,
                         dataclasses.replace(mamba2_13b.CONFIG, **paged),
                         "serve_mamba2")
    served["mamba2-1.3b"] = mserve
    del mserve["params"]
    torch.cuda.empty_cache()
    oserve = phase_serve(gpu, args.seed,
                         dataclasses.replace(olmoe_1b_7b.CONFIG, **paged),
                         "serve_olmoe")
    served["olmoe-1b-7b"] = oserve
    del oserve["params"]
    torch.cuda.empty_cache()
    fp32 = dict(dtype="float32", cache_layout="paged", kv_page_size=PSZ)
    phase_e2e(gpu, args.seed,
              dataclasses.replace(yi_9b.CONFIG, n_layers=4, **fp32))
    phase_e2e(gpu, args.seed,
              dataclasses.replace(mamba2_13b.CONFIG, n_layers=4, **fp32))
    phase_e2e(gpu, args.seed,
              dataclasses.replace(zamba2_27b.CONFIG, n_layers=12, **fp32))
    olmoe = dataclasses.replace(olmoe_1b_7b.CONFIG, n_layers=4, **fp32)
    phase_e2e(gpu, args.seed, olmoe, compare="pallas_paged vs xla, dense")
    olmoe_sorted = dataclasses.replace(olmoe, moe_dispatch="sorted")
    phase_e2e(gpu, args.seed, olmoe_sorted,
              compare="pallas_paged vs xla, sorted", ragged=False)
    # Capacity factor 8: no expert can overflow, so sorted equals dense.
    phase_e2e(gpu, args.seed,
              dataclasses.replace(olmoe_sorted, capacity_factor=8.0),
              want=dataclasses.replace(olmoe, decode_kernel="pallas_paged"),
              compare="sorted (capacity factor 8) vs dense, pallas_paged")

    def launched(*keys, runs="launches"):
        """(total, by path) of the main paths' launches of ``keys``."""
        by_path = {arch: sum(run[runs][k] for k in keys)
                   for arch, run in served.items() if runs in run}
        return sum(by_path.values()), by_path

    dec = kern["main"]
    rows = [("paged_decode_attention", "decode_attention",
             launched("decode_paged"), kern["errs"]["paged_decode_attention"],
             dict(dec, ms=dec["paged_ms"])),
            ("decode_attention", "decode_attention",
             launched("decode_dense", runs="gather_launches"),
             kern["errs"]["decode_attention"],
             dict(dec, ms=dec["dense_ms"], plain_ms=dec["dense_plain_ms"])),
            ("flash_attention", "flash_attention",
             launched("flash_paged", "flash_dense"), flash["err"],
             flash["main"]),
            ("fused_norm", "fused_norm", launched("fused_norm"), norm["err"],
             norm["main"]),
            ("ssd", "ssd", launched("ssd"), ssd["err"], ssd["main"]),
            ("grouped_matmul", "moe_gmm", launched("grouped_matmul"),
             gmm["err"], gmm["main"]),
            ("matmul", "matmul",
             (mm["launches"]["matmul"],
              {"policy_matmul": mm["launches"]["matmul"]}),
             mm["errs"]["accumulate"], mm["accumulate"]),
            ("matmul(split_k>1)", "matmul",
             (mm["launches"]["matmul_split"],
              {"policy_matmul": mm["launches"]["matmul_split"]}),
             mm["errs"]["split"], mm["split"])]
    summary = []
    for name, source, (count, by_path), err, row in rows:
        summary.append({
            "name": name, "route": "cuda", "source": SOURCES[source],
            "replaces": TPU_SITES[name], "launches": count,
            "launches_by_path": by_path, "max_abs_err": err,
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
        })
    emit({"kernels": summary})
    print(gpu, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
