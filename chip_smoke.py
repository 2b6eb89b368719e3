#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA H100.

    python3 chip_smoke.py [--seed N]

Phases, each printing one JSON line; any failure raises and exits non-zero:

1. card and build: the card's name and power limit, the CUDA version, its
   properties (SMs, memory, L2) beside the policy engine's H100 model, and
   the time to build the six CUDA kernels (split-KV decode attention,
   flash attention, fused norm, the Mamba-2 SSD scan, the MoE grouped GEMM,
   the policy-planned matmul; one nvcc each, started together) from
   src/repro_torch/kernels/*/csrc/*.cu for sm_90a into build/repro_torch/,
   and the registers, stack and spills nvcc -Xptxas -v reports for the two
   attention kernels, the planned matmul, the SSD scan, the fused norm and
   the grouped GEMM;
2. kernels against their plain PyTorch versions on the card, bf16 and fp32,
   tolerance (TOL) fp32 2e-3, bf16 4e-3 + 2^-7 |want|:
   * decode attention at yi-9b's decode shapes (hq 32, hkv 4, d 128,
     page 16, 16 slots, contexts 512 and 2048, splits 1, the count the
     policy engine plans for the serve engine (4) and 8, the count of the
     plan-free default), at the serve arms' ragged live lengths (32-1152,
     one parked slot) at the same splits, at granite-20b's MQA shape (hq
     48, hkv 1: three group tiles), paged == dense bitwise, each beside
     the device time of its combine_partials, the reference's property
     cases, and the dense kernel over cross-attention's fixed-source K/V
     by strides (whisper-small: 1500 keys, 12 heads of 64; the VLM: 1600
     keys, 64 query over 8 KV heads of 128), each at the split count
     planned over its source length;
   * flash attention (which body ran, and the share of TOL its error
     uses) at the prefill's main shape (16 x 1024 causal), at
     the serve path's ragged shape (pad 1024 over a 2048-position page
     view, per-slot offsets, key and query lengths, parked slots; paged ==
     dense bitwise) and a prefix attach (a 512-token suffix at offset 512
     over shared pages) against the whole prompt's rows, and without the
     causal mask at whisper-small's encoder (16 x 12 heads x 1500 x 1500,
     d 64, bf16 and fp32) and the VLM's cross prefill (16 x 64/8 heads,
     1024 ragged rows over 1600 keys, d 128);
   * fused norm at 16 x 1024 x 4096 and 16 x 1 x 4096 (RMS with and
     without residual, LayerNorm with bias), each with the body that ran
     (vector, scalar), its threads a row and rows a block, its time over
     the bound, and the scalar body's time on the same rows; then
     whisper-small's LayerNorm (d 768) and the VLM's RMSNorm (d 8192);
   with device timings (CUDA graph replay, CUDA events) of kernel, plain
   version, the nearest PyTorch library call and the least time the work
   can take (the bound);
3. serve yi-9b at its published config (48 layers, bf16, random weights
   from a seed) through ServeEngine over a paged pool, each decode chunk
   one CUDA graph replay (the engine's default): 48 greedy requests,
   every kernel's launch count checked (decode 48 x steps, flash 48 x
   waves, fused norm 97 x (waves + steps), 0 plain calls; a replay adds
   its captured launches, and one replay, profiled after the run, must
   launch each kernel as often as its capture counted), one replay a
   chunk, ms per chunk and peak memory (allocated, reserved, the graph's
   pool); then the first 16 requests with the graph off (the eager loop)
   and under pallas_gather, each with bitwise-equal streams; a
   torch.profiler trace of one decode chunk with the graph on and off
   from the same state (device busy time, idle share, peak memory,
   kernels by device time, and every kernel the profiler sees inside the
   replay) and of one admission wave;
4. prefix sharing and preemption at the same width, cut to 12 of the 48
   layers: 48 requests on four
   shared 512-token system prompts over a 256-page pool, invariants
   checked after every wave, hits and preemptions required, no page left
   held; the same requests with sharing off for comparison;
5. the kernel path against the plain path end to end: yi-9b's width at 4
   layers in fp32, prefill, decode steps and a continuation prefill at a
   nonzero cursor, logits within 2e-3;
6. the SSD scan kernel against its plain version, bf16 and fp32, at
   mamba2-1.3b's prefill shape (16 x 1024, 64 heads of 64, state 128) and
   zamba2-2.7b's (80 heads, state 64), two grouped cases at ragged lengths
   (state 64 and 128, 2 groups) and a one-row prefill, each from a nonzero
   initial state with ragged dt-zero tails and a parked slot whose state
   must come back bitwise; each row with the body that ran (mma,
   cuda_cores), its heads a block and blocks, and the share of its
   tolerance that y and the state use; the models' shapes timed beside
   the bound and, in bf16, the cuda_cores body on the same inputs (no
   PyTorch call computes the scan, so no library time);
7. decode and flash attention at zamba2's shapes (32 query and 32 KV heads,
   head dim 80), paged == dense bitwise, timed beside SDPA;
8. serve zamba2-2.7b at its published config (54 Mamba-2 layers and 9
   shared-attention invocations, bf16, random weights) over a paged pool:
   the same 48 requests, launch counts checked (ssd 54 x waves, flash
   9 x waves, decode 9 x steps, fused norm 73 x (waves + steps), 0 plain
   calls), the first 16 with the graph off and under pallas_gather with
   bitwise-equal streams, a trace of one decode chunk (graph on and off)
   and one admission wave; then the 48 requests on a 256-page pool with
   preemption and invariants after every wave;
9. serve mamba2-1.3b at its published config (48 layers, bf16) with a paged
   layout requested: the engine falls back to contiguous bookkeeping;
   launch counts ssd 48 x waves, fused norm 49 x (waves + steps), no
   attention, 0 plain calls; the first 16 with the graph off (streams
   bitwise equal); a trace of one decode chunk (graph on and off) and one
   admission wave;
10. kernel path against plain path end to end for mamba2 (full width, 4
   layers) and zamba2 (full width, 12 layers: two groups), fp32, as in 5;
11. the MoE grouped GEMM against its plain version, bf16 and fp32, at
   olmoe-1b-7b's expert products: a dense-dispatch prefill wave through
   wg/wu and through wd, a decode step, a sorted-dispatch wave's capacity
   buffers with counts (rows past each count exactly 0), ragged shapes, a
   prefill at 1000 rows an expert and one with counts at and inside row
   tiles; each row with the body that ran (wgmma, decode, wmma,
   cuda_cores; equal to plan_launch's and to the case's), its CTAs and
   cluster, a repeat bitwise, timed beside its bound (over_bound) and
   torch.bmm (library_over);
12. serve olmoe-1b-7b at its published config (16 layers, 64 experts top 8,
   bf16, random weights) over a paged pool under dense dispatch: the same
   48 requests, launch counts checked (grouped GEMM 3 x 16 x (waves +
   steps): the waves' on the wgmma body, the steps' on the decode body;
   flash 16 x waves, decode 16 x steps, fused norm 33 x (waves + steps), 0
   plain calls), the first 16 with the graph off and under pallas_gather
   with bitwise-equal streams, a trace of one decode chunk (graph on and
   off) and one admission wave; then granite-20b (52 layers, d 6144, 48
   query heads over one KV head: the decode kernel's group of 48, GELU
   MLP; 20.3 B parameters) and minicpm-2b (40 layers, 36 heads of 64,
   tied embeddings, vocab 122753 -> 122880) at their published configs,
   the same 48 requests with the graph on, launch counts and the planned
   split count checked;
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
   launches of both schedules (accumulating and split-K, whose partials
   are summed inside the kernel) counted against the plans; then for each
   distinct schedule the kernel against its plain version, mnk == nmk and
   a repeat bitwise, the body that ran (wgmma, small_m, cp_async, masked,
   cuda_cores), its CTAs and cluster, its time beside the plan's modeled
   time, the plain version, torch.matmul and the bound, the achieved
   TFLOP/s and GB/s and the time over the bound, and per shape the fastest
   mode on the card beside the fastest by the model;
15. speculative decode at yi-9b's width (``serve_spec``) and zamba2's
   cut to 18 of its 54 layers (``serve_spec_zamba2``, the replay
   rollback): benchmarks/serve_bench.py's
   recipe scaled to the arm (64 greedy streams of seeded 64-token prompts
   from the plain graphed engine, their tails ranked by the n-gram oracle,
   the 16 most repetitive resumed 256 tokens in to decode 128), served by
   the plain engine and by the speculative one (spec_k 4, n-gram 3, chunk
   10: two draft/verify/rollback rounds a graph replay), launch counts
   checked (one prefill a round, two under replay), one replay's kernels
   held to the capture's, the eager twin's streams bitwise equal to the
   graph's; acceptance, tokens a round, ms a chunk, tok/s beside the plain
   engine's, and the streams equal to the plain engine's (counted: the
   verify is a prefill at other bf16 shapes);
16. the adaptive serve-tier policy at yi-9b's width, cut to 12 layers
   (``serve_adaptive``):
   serve_bench's mixed trace with token and page counts x16 (a 768-token
   system prompt re-arriving beside 576-token junk prompts, 6 rounds, 2
   slots, 128 pages, 48 warm), legs static_off, static_retain,
   static_bypass and adaptive, the reference's placement gates (adaptive's
   prefill work at most the best static leg's, >= 1 re-plan and warm hit,
   the novel class at bypass, no page leaked) and per leg the re-arrival
   TTFT;
17. ``spec_identity``: fp32 speculative streams bitwise equal to plain
   ones at yi-9b's width cut to 4 layers (rewind) and zamba2's cut to 6
   (replay), 16 requests each, with the n-gram proposer and with an oracle
   proposer that drafts the plain streams (so drafts are accepted);
18. ``serve_sampling``: the serve arm's 48 requests at yi-9b's width,
   cut to 12 layers, greedy and then under seeded top-p (0.9 at temperature 0.8, request i
   seed 1000 + i), back to back: launch counts and one replay's kernels
   checked, tok/s and ms a chunk of each, the first 16 sampled ones with
   the graph off bitwise equal; a traced greedy and sampled chunk from
   one state, and the sampler alone (whole, and its threefry folds,
   Gumbel noise and top-p sort), timed, 8 steps of it over the sampled
   chunk's device time; its keys, bits and uniforms bitwise equal to the
   CPU's at the chunk's shape;
19. ``serve_snapshot``: the serve arm, cut to 12 layers, with
   kv_integrity off and then on,
   back to back (the on-device fingerprint sweep timed, streams bitwise
   equal, no mismatch), a crash leg (journal, snapshot after wave 2, kill
   at wave 4, restore on a fresh graphed engine; snapshot and restore
   times, every request finished, no page held, first tokens and streams
   equal to the uninterrupted run's counted), a chaos_corrupt_p leg
   (every flip found and quarantined, invariants every wave), and at 4
   layers in fp32 restore and corruption runs whose streams must equal
   the uninterrupted run's bitwise;
20. ``sampling_identity``: fp32 at yi-9b's width cut to 4 layers and
   zamba2's cut to 6, 16 seeded requests: reversed submission (top-p), a
   preempting 128-page pool (top-p) and speculative against plain decode
   (temperature, an oracle proposer) all give the same streams bitwise;
21. ``serve_whisper``: whisper-small at its published config (12 encoder
   and 12 decoder layers, bf16, random weights) over a paged pool, each
   slot's encoder frames (16 x 1500 x 768) drawn from the seed: the same
   48 requests, launch counts checked (decode 12 x steps on the page pool
   and 12 x steps over the cross K/V, flash 12 x waves each way, fused
   norm 37 x (waves + steps); the encoder's launches run at the engine's
   construction), one replay's kernels held to the capture's, the first
   16 with the graph off and under pallas_gather with bitwise-equal
   streams, a trace of one decode chunk (graph on and off) and one
   admission wave, and ``encode_ms`` (the encoder and every layer's cross
   projection for the 16 slots) and the cross K/V's bytes;
22. ``serve_vlm``: llama-3.2-vision-90b at full width with its depth cut
   from 100 to 20 layers (4 groups of 4 self layers and a cross layer),
   vision tokens (16 x 1600 x 8192) from the seed, the same 48 requests,
   launch counts (decode 16 x steps paged and 4 x steps over the cross
   K/V, flash 16 and 4 x waves, fused norm 41 x (waves + steps)), the
   planned split count, ``encode_ms`` and the cross K/V's bytes;
23. whisper-small end to end at full width and depth, kernel route
   against plain route as in 5 (the encoder, the cross prefill and the
   cross decode on each route): fp32 logits within 2e-3, then in bf16
   the routes' gap measured beside the logits' magnitude;
24. the trainer at minicpm-2b's full width (d 2304, 36 heads of 64, tied
   vocab 122753 -> 122880), bf16 but where stated: ``forward_kernels``,
   ``forward`` under no_grad on the kernel route (flash causal with no
   cache, the fused norm) against "xla", fp32 at 4 layers within TOL and
   bf16 at 40 layers measured, launches flash L and norms 2 L + 1;
   ``train_remat``, one forward + backward under each activation policy
   at 4 layers from one state and batch (saved and peak bytes above the
   state, a layer's share beside choose_policy's 0.45 / 0.06, time beside
   extra_flops_factor's 1.12 / 1.33, losses and gradients agreeing);
   ``train_minicpm``, 8 train steps at full depth (2.725 B parameters,
   4 x 2048 tokens, SAVE_DOTS, warmup-stable-decay): finite, falling
   losses, every gradient reached, step ms, tokens/s, model TFLOP/s, peak
   memory; ``train_resume``, loop.run 3 steps + checkpoint + restore + 3
   against 6 straight at 2 layers (restore and batches bitwise);
25. ``suite``: the paper's 17 workloads (``workloads.suite``) costed by the
   H100 policy engine's model under each static mode beside adaptive's
   (how many of the 17 adaptive matches within 5 %: recorded, not gated),
   and the runnables (relu, softmax, the 3 x 3 stride-2 pool, the GEMMs,
   DGEMM in float32 and float64) on the card against the CPU on the same
   inputs, fp32 within TOL with TF32 off;
26. ``sp_decode``: sequence-parallel decode (``distributed.sp_decode``)
   at yi-9b's attention width (32/4 heads of 128, bf16): 4 spawned ranks
   share the card over gloo (NCCL will not put two ranks on one device),
   each running the split-KV kernel over its quarter of the sequence (one
   launch a rank, counted there; no plain call), merged by a log-sum-exp
   all-reduce through the host; long_500k (b 1, 524288 tokens, 1.07 GB of
   K/V) and a ragged b 4 case whose last shard holds no live position;
   V's rows carry a ramp in position so the output is O(1); each slot
   within bf16 3e-2 of its largest |output| against the one-rank kernel
   over the whole cache and its plain version, each rank's merged
   partials against the plain ones of its shard; the ranks' local
   kernel, merge and whole ms beside the one-rank kernel's and the bound;
27. ``train_dp``: data-parallel ZeRO-1 training (``train.step`` over a
   (2, 1) mesh) at minicpm-2b's full width, 2 spawned ranks on the card
   over gloo: fp32 at 2 layers, one step equal to the one-process step on
   the same global batch (loss rtol 1e-4, params 5e-3, the gathered first
   moments 1e-3 of each leaf's largest), parameters bitwise across ranks
   (checksums of their bits), each rank's moments half the bytes, the
   ranks' checkpoint restored in a one-rank layout bitwise; bf16 cut to 4
   layers, 3 steps with the step's fp32 gradient all-reduce and 3 with
   each gradient averaged by ``compressed_all_reduce`` (step and
   all-reduce ms, payload bytes, moment bytes, the loss gap);
28. ``tp_forward``, ``tp_forward_whisper``, ``tp_forward_vlm``,
   ``tp_forward_mamba2``, ``tp_forward_zamba2``: tensor and
   expert parallel execution over ``model`` (``build_model(cfg, device,
   mesh)``, a (1, 4) mesh) on the kernel route, one spawn of 4 ranks that
   share the card over gloo for five models, each rank holding its
   blocks drawn from the one-process seed: phi3.5-moe-42b-a6.6b at full
   width, dense dispatch, 4 x 512 tokens (8 query and 2 KV heads, 4 of
   the 16 experts, a quarter of the vocabulary a rank; flash, the fused
   norm at d 4096 and the grouped GEMM over 4 experts x 2048 rows; fp32
   at 2 layers, bf16 at 8); whisper-small at full depth (12 + 12 layers),
   4 x 448 tokens, frames 4 x 1500 x 768 from the seed (3 heads of 64 a
   rank; flash causal, bidirectional over the encoder's 1500 rows and
   over the 1500 frames in the cross layers, the LayerNorm with bias at
   d 768; fp32 and bf16); llama-3.2-vision-90b at full width cut by depth
   (fp32 at 1 group of 4 self layers and 1 cross layer, bf16 at 2), 2 x
   256 tokens, vision tokens 2 x 1600 x 8192 from the seed (16/2 heads of
   128 a rank, ``vis_proj`` split by columns and gathered; flash causal
   and over the 1600 vision keys, RMS at d 8192); mamba2-1.3b (fp32 at 12
   of 48 layers, bf16 at 48) and zamba2-2.7b (fp32 at 12 of 54, bf16 at
   54), 2 x 256 tokens (16 and 20 SSM heads of 64 a rank, the SSD scan on
   them with the one group they read, state 128 and 64; zamba2's shared
   block 8/8 heads of 80 through flash); each kernel first held
   to its plain version at a rank's shapes (bf16 and fp32); each fp32
   arm's gathered logits (rank 0) within 2e-3 of the largest |logit| of
   the one-process kernel-route forward (computed first in this process,
   its weights freed before the ranks start), each bf16 arm's gap
   measured; per rank the forward ms with the collectives' ms clocked
   inside it, staged collectives and bytes, peak memory and launches,
   held to flash once an attention and the norm once a norm (whisper:
   flash 12 + 2 x 12, norms 2 x 12 + 3 x 12 + 2; mamba2: SSD L, norms
   L + 1; zamba2: SSD L, flash L/6, norms L + 2 L/6 + 1; else flash L,
   norms 2 L + 1), grouped GEMM 3 L (``cuda_cores`` in fp32, ``wgmma`` in
   bf16), no plain call;
29. ``train_tp``, ``train_tp_whisper``, ``train_tp_zamba2``: the ZeRO-1
   train step over a (1, 4) mesh on the plain route, fp32, 2 steps, one
   spawn: yi-9b at
   full width cut to 2 layers, 4 x 512 tokens (8 query heads and 1 KV
   head, a quarter of d_ff and of the vocabulary a rank, the
   vocab-parallel loss), its first moments gathered; whisper-small at
   full depth, 2 x 448 tokens and frames; zamba2-2.7b at full width cut
   to 6 layers (one group and the shared block), 2 x 256 tokens, its
   first moments gathered; losses within 1e-5 relative of
   rank 0's one-process steps and equal across ranks, the gathered first
   moments within 1e-3 of each leaf's largest, whisper's gathered
   checkpoint restored at one rank bitwise; step and collective ms,
   staged bytes, peak memory;
and in phase 2's flash rows the verify shape (16 slots, q_len 5 at the
cursor over ragged 512-2048 keys, paged) beside SDPA with an explicit mask
and the bound.  Every phase line carries ``at_s``, the seconds since the
script started.

Then the kernels' summary line, the card's line from nvidia-smi, and the
result line ``{"ok": true, "device": {...}}`` last.  Without a CUDA card it
exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import os
import pathlib
import re
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


_T0 = time.perf_counter()


def emit(obj) -> None:
    """Print one JSON line; a phase's line also gets ``at_s``, the seconds
    since the script started."""
    if "phase" in obj:
        obj = {**obj, "at_s": time.perf_counter() - _T0}
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


def tol_used(got, want, dtype) -> float:
    """The largest share of its tolerance that any element's error uses:
    max |got - want| / (atol + rtol |want|) (TOL); a check passes below 1."""
    got, want = got.float(), want.float()
    atol, rtol = TOL[dtype]
    return ((got - want).abs() / (atol + rtol * want.abs())).max().item()


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
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        _flush.zero_()
        # Keep the card busy (~50 us) while the host queues the start event
        # and the replay: a host delay there would otherwise count as
        # device time in a kernel of a few microseconds.
        torch.cuda._sleep(100_000)
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
                    "combine_ms": _combine_ms(SLOTS, HQ, splits, D),
                }
                rows.append(row)
                if dtype == torch.bfloat16 and ctx == 2048 and splits == planned:
                    main = row
    ragged = _decode_ragged(gen, planned, errs)
    group48 = _decode_group48(gen, errs)
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
    cross = _decode_cross(gen, errs)
    torch.cuda.synchronize()
    emit({"phase": "kernels", "gpu": gpu, "rows": rows,
          "ragged_rows": ragged, "group48_rows": group48,
          "cross_rows": cross,
          "planned_splits": planned, "ring_splits": splits,
          "ring_err": e_ring, "property_cases": props,
          "tol_atol_rtol": {str(t).removeprefix("torch."): v
                            for t, v in TOL.items()}})
    return {"main": main, "errs": errs, "cross": cross}


def _combine_ms(b: int, hq: int, splits: int, d: int) -> float:
    """Device time of ``combine_partials`` (torch ops) on partials of one
    decode call's shape: the part of a decode call's time that is not the
    kernel's."""
    from repro_torch.kernels.decode_attention import decode_attention as dk

    acc = torch.randn(b, hq, splits, d, device="cuda")
    m = torch.randn(b, hq, splits, device="cuda")
    l = torch.rand(b, hq, splits, device="cuda") + 0.5
    return time_ms(lambda: dk.combine_partials(acc, m, l).to(torch.bfloat16))


def _decode_case(tag, q, kp, vp, pages, lengths, splits, errs, hkv=HKV):
    """One decode case on the card: paged and dense (the gathered view,
    bkv = page) kernels against their plain versions and the oracle on the
    live slots (a parked slot must give exact zeros), paged == dense
    bitwise; timed beside the plain version, SDPA and the bound."""
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention import decode_attention as dk
    from repro_torch.kernels.decode_attention import ref
    from repro_torch.models.common import gather_pages

    dtype = q.dtype
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

    out_p, out_d, want = paged(), dense(), plain()
    torch.cuda.synchronize()
    e_p = check_close(f"{tag} paged s{splits}", out_p, want, dtype)
    e_d = check_close(f"{tag} dense s{splits}", out_d, dk.decode_attention_plain(
        q, kd, vd, lengths, bkv=PSZ, splits=splits), dtype)
    check_equal(f"{tag} paged == dense s{splits}", out_p, out_d)
    live = lengths > 0
    check_close(f"{tag} oracle s{splits}", out_p[live],
                ref.decode_attention(q, kd, vd, lengths)[live], dtype)
    if bool((~live).any()) and bool(out_p[~live].abs().max() != 0):
        raise AssertionError(f"{tag}: a length-0 slot must give 0")
    errs["paged_decode_attention"] = max(errs["paged_decode_attention"], e_p)
    errs["decode_attention"] = max(errs["decode_attention"], e_d)
    kdc, vdc = kd.contiguous(), vd.contiguous()
    mask = (torch.arange(kd.shape[2], device="cuda")[None, :]
            < lengths[:, None])[:, None, None, :]
    hq = q.shape[1]

    def library():
        return F.scaled_dot_product_attention(
            q[:, :, None], kdc, vdc, attn_mask=mask, enable_gqa=True)

    bound_ms, bound_by = _bound(dtype, lengths, q.shape[0],
                                int((pages >= 0).sum()), hq, hkv, q.shape[2])
    return {"dtype": str(dtype).removeprefix("torch."), "splits": splits,
            "lengths": lengths.tolist(), "paged_ms": time_ms(paged),
            "dense_ms": time_ms(dense), "plain_ms": time_ms(plain),
            "library_ms": time_ms(library), "bound_ms": bound_ms,
            "bound_by": bound_by, "paged_err": e_p, "dense_err": e_d,
            "paged_equals_dense": True,
            "combine_ms": _combine_ms(q.shape[0], q.shape[1], splits,
                                      q.shape[2])}


def _decode_ragged(gen, planned: int, errs: dict) -> list[dict]:
    """yi-9b's decode at the serve arms' live lengths (32-1152 of 2048
    positions, one parked slot) at splits 1, planned and 8: each split
    walks an equal share of its slot's live pages."""
    n_table = MAX_LEN // PSZ
    lengths = torch.randint(32, 1153, (SLOTS,), generator=gen,
                            device="cuda", dtype=torch.int32)
    lengths[5] = 0
    q, kp, vp, pages = _pool_case(gen, torch.bfloat16, lengths, n_table,
                                  SLOTS * n_table)
    return [_decode_case("decode ragged", q, kp, vp, pages, lengths,
                         splits, errs) for splits in sorted({1, planned, 8})]


def _decode_group48(gen, errs: dict) -> list[dict]:
    """granite-20b's attention shape (hq 48, hkv 1, d 128: MQA, three
    group tiles of 16) over 16 slots x 2048 positions, bf16 and fp32."""
    n_table = MAX_LEN // PSZ
    hq, hkv = 48, 1
    splits = planned_splits(hq, hkv, D)
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        lengths = torch.randint(1, MAX_LEN + 1, (SLOTS,), generator=gen,
                                device="cuda", dtype=torch.int32)
        lengths[0] = MAX_LEN
        q, kp, vp, pages = _pool_case(gen, dtype, lengths, n_table,
                                      SLOTS * n_table, hq=hq, hkv=hkv)
        rows.append(_decode_case(f"decode group 48 {dtype}", q, kp, vp,
                                 pages, lengths, splits, errs, hkv=hkv)
                    | {"shape": [SLOTS, hq, hkv, MAX_LEN, D]})
        del q, kp, vp, pages
    return rows


# (case, hq, hkv, t, d): the cross-attention decode step's shapes, whisper-
# small's (12 heads of 64 over the 1500 encoder states) and the VLM's (64
# query heads over 8 KV heads of 128, 1600 vision tokens).
DECODE_CROSS = (("whisper-small", 12, 12, 1500, 64),
                ("llama-3.2-vision-90b", 64, 8, 1600, 128))


def _decode_cross(gen, errs: dict) -> list[dict]:
    """The dense decode kernel over fixed-source cross K/V (b, t, hkv, d)
    read by strides, every key valid, bkv min(512, t), at the split count
    the model plans over the source length (DECODE_CROSS, bf16, 16 slots):
    against the plain version and the oracle, timed beside SDPA, the
    bound and the combine."""
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention import decode_attention as dk
    from repro_torch.kernels.decode_attention import ref
    from repro_torch.kernels.decode_attention.ops import plan_splits

    dtype, b, rows = torch.bfloat16, SLOTS, []
    for case, hq, hkv, t, d in DECODE_CROSS:
        bkv = min(512, t)
        splits = plan_splits(t, bkv)
        q = torch.randn(b, hq, d, generator=gen, device="cuda").to(dtype)
        kv = torch.randn(2, b, t, hkv, d, generator=gen,
                         device="cuda").to(dtype)
        k, v = kv[0].transpose(1, 2), kv[1].transpose(1, 2)
        lengths = torch.full((b,), t, dtype=torch.int32, device="cuda")

        def kernel():
            return dk.decode_attention_cuda(q, k, v, lengths, bkv=bkv,
                                            splits=splits)

        def plain():
            return dk.decode_attention_plain(q, k, v, lengths, bkv=bkv,
                                             splits=splits)

        kc, vc = k.contiguous(), v.contiguous()

        def library():
            return F.scaled_dot_product_attention(q[:, :, None], kc, vc,
                                                  enable_gqa=True)

        got, want = kernel(), plain()
        torch.cuda.synchronize()
        e = check_close(f"decode cross {case}", got, want, dtype)
        check_close(f"decode cross {case} oracle", got,
                    ref.decode_attention(q, k, v, lengths), dtype)
        errs["decode_attention"] = max(errs["decode_attention"], e)
        bound_ms, bound_by = _bound(dtype, lengths, b, 0, hq, hkv, d)
        row = {"case": case, "dtype": "bfloat16",
               "shape": [b, hq, hkv, t, d], "bkv": bkv, "splits": splits,
               "err": e, "library_err": (library()[:, :, 0].float()
                                         - want.float()).abs().max().item(),
               "ms": time_ms(kernel), "plain_ms": time_ms(plain),
               "library_ms": time_ms(library), "bound_ms": bound_ms,
               "bound_by": bound_by,
               "combine_ms": _combine_ms(b, hq, splits, d)}
        row["over_bound"] = row["ms"] / bound_ms
        rows.append(row)
        del q, kv, k, v, kc, vc
    return rows


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


def _flash_work(off, q_len, kv_len, causal: bool = True):
    """(keys needed per slot, valid query-key pairs) of a call; without
    ``causal`` every valid row sees every key below kv_len."""
    off, q_len, kv_len = (x.long().cpu() for x in (off, q_len, kv_len))
    pairs, need = 0, []
    for o, n, t in zip(off.tolist(), q_len.tolist(), kv_len.tolist()):
        if not causal:
            pairs += n * t
            need.append(t if n else 0)
            continue
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
               "body": fk.body(q, k, v),
               "err": e, "tol_used": tol_used(got, want, dtype),
               "library_err": (library().float() - want.float()
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
                     "body": fk.body(q, kp, vp),
                     "q_len": q_len.tolist(), "q_offset": off.tolist(),
                     "err": e, "tol_used": tol_used(out_p, want, dtype),
                     "paged_equals_dense": True,
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
                 "body": fk.body(q, kp, vp),
                 "prefix": pre, "suffix": sq - pre, "err": e_attach,
                 "plain_err": e_plain,
                 "bitwise_equal": bool(torch.equal(attached,
                                                   whole[:, :, pre:]))})
    del kp, vp, q, whole, attached
    verify = _flash_verify(gen, n_table)
    err = max(err, verify["err"])
    rows.append(verify)
    source = _flash_source(gen)
    err = max([err] + [r["err"] for r in source])
    rows += source
    emit({"phase": "kernels_flash", "gpu": gpu, "rows": rows})
    return {"main": main, "err": err, "verify": verify,
            "encoder": source[0], "cross": source[2]}


def _flash_verify(gen, n_table: int) -> dict:
    """The speculative verify's shape, bf16: each of 16 slots scores
    spec_k + 1 = 5 query rows at its cursor over ragged 512-2048 keys
    through its page table; against the plain version, SDPA with an
    explicit mask over the gathered view, and the bound."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import flash_attention as fk
    from repro_torch.models.common import gather_pages

    dtype, b, sq = torch.bfloat16, SLOTS, SPEC_K + 1
    kp, vp, pages = _paged_pool(gen, dtype, b, n_table, b * n_table)
    kv_len = torch.randint(512, MAX_LEN + 1, (b,), generator=gen,
                           device="cuda", dtype=torch.int32)
    off = (kv_len - sq).to(torch.int32)
    q_len = torch.full((b,), sq, dtype=torch.int32, device="cuda")
    mapped = (kv_len.long() + PSZ - 1) // PSZ
    pages = torch.where(torch.arange(n_table, device="cuda")[None]
                        < mapped[:, None], pages, -1).to(torch.int32)
    pages = pages.contiguous()
    q = torch.randn(b, sq, HQ, D, generator=gen,
                    device="cuda").to(dtype).transpose(1, 2)
    kw = dict(q_offset=off, kv_len=kv_len, q_len=q_len)
    kd = gather_pages(kp, pages).transpose(1, 2).contiguous()
    vd = gather_pages(vp, pages).transpose(1, 2).contiguous()
    kpos = torch.arange(kd.shape[2], device="cuda")
    qpos = off[:, None].long() + torch.arange(sq, device="cuda")
    mask = ((kpos[None, None] < kv_len[:, None, None])
            & (kpos[None, None] <= qpos[:, :, None]))[:, None]

    def paged():
        return fk.paged_flash_attention_cuda(q, kp, vp, pages, **kw)

    def plain():
        return fk.paged_flash_attention_plain(q, kp, vp, pages, **kw)

    def library():
        return F.scaled_dot_product_attention(q, kd, vd, attn_mask=mask,
                                              enable_gqa=True)

    got, want = paged(), plain()
    torch.cuda.synchronize()
    e = check_close("flash verify", got, want, dtype)
    need, pairs = _flash_work(off, q_len, kv_len)
    bound_ms, bound_by = _flash_bound(dtype, q_len.cpu(), need, pairs, b,
                                      sq, HQ, HKV, D)
    row = {"case": "verify", "dtype": "bfloat16", "body": fk.body(q, kp, vp),
           "shape": [b, HQ, HKV, sq, MAX_LEN, D], "kv_len": kv_len.tolist(),
           "err": e, "tol_used": tol_used(got, want, dtype),
           "library_err": (library().float() - want.float()).abs().max()
           .item(),
           "ms": time_ms(paged), "plain_ms": time_ms(plain, reps=5),
           "library_ms": time_ms(library), "bound_ms": bound_ms,
           "bound_by": bound_by}
    row["over_bound"] = row["ms"] / bound_ms
    return row


# (case, b, hq, hkv, sq, skv, d, ragged q_len): whisper-small's encoder
# self-attention (12 heads of 64 over the 1500 frames) and the VLM's cross
# prefill (64 query heads over 8 KV heads of 128, the prefill's 1024 rows
# over 1600 vision tokens), both bidirectional.
FLASH_SOURCE = (("encoder", SLOTS, 12, 12, 1500, 1500, 64, False),
                ("cross", SLOTS, 64, 8, PREFILL_PAD, 1600, 128, True))


def _flash_source(gen) -> list[dict]:
    """The flash kernel with ``causal=False`` at the fixed-source shapes
    (FLASH_SOURCE; neither is a multiple of the 64-row tile in keys), in
    the models' layouts ((b, s, h, d) rows and (b, t, hkv, d) K/V taken by
    strides): the encoder in bf16 and fp32, the cross prefill in bf16
    with ragged query lengths (two parked slots, whose rows must be zero);
    each against the plain version, SDPA and the bound."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import flash_attention as fk

    rows = []
    for case, b, hq, hkv, sq, skv, d, ragged in FLASH_SOURCE:
        for dtype in ((torch.bfloat16,) if ragged
                      else (torch.bfloat16, torch.float32)):
            q = torch.randn(b, sq, hq, d, generator=gen,
                            device="cuda").to(dtype).transpose(1, 2)
            kv = torch.randn(2, b, skv, hkv, d, generator=gen,
                             device="cuda").to(dtype)
            k, v = kv[0].transpose(1, 2), kv[1].transpose(1, 2)
            q_len = torch.full((b,), sq, dtype=torch.int32, device="cuda")
            if ragged:
                q_len = torch.randint(1, sq + 1, (b,), generator=gen,
                                      device="cuda", dtype=torch.int32)
                q_len[3] = 0
                q_len[7] = 0
            kw = dict(causal=False, q_len=q_len if ragged else None)

            def kernel():
                return fk.flash_attention_cuda(q, k, v, **kw)

            def plain():
                return fk.flash_attention_plain(q, k, v, **kw)

            kc, vc = k.contiguous(), v.contiguous()

            def library():
                return F.scaled_dot_product_attention(q, kc, vc,
                                                      enable_gqa=True)

            got, want = kernel(), plain()
            torch.cuda.synchronize()
            e = check_close(f"flash {case} {dtype}", got, want, dtype)
            live = (torch.arange(sq, device="cuda")[None, :]
                    < q_len[:, None])[:, None, :, None]
            if bool((got * ~live).abs().max() != 0):
                raise AssertionError(f"flash {case}: rows past q_len must "
                                     "be zero")
            lib = library()
            need, pairs = _flash_work(torch.zeros(b), q_len,
                                      torch.full((b,), skv), causal=False)
            bound_ms, bound_by = _flash_bound(dtype, q_len.cpu(), need,
                                              pairs, b, sq, hq, hkv, d)
            row = {"case": case, "dtype": str(dtype).removeprefix("torch."),
                   "shape": [b, hq, hkv, sq, skv, d], "causal": False,
                   "body": fk.body(q, k, v),
                   "q_len": q_len.tolist() if ragged else None,
                   "err": e, "tol_used": tol_used(got, want, dtype),
                   "library_err": ((lib.float() - want.float()) * live
                                   ).abs().max().item(),
                   "ms": time_ms(kernel), "plain_ms": time_ms(plain, reps=5),
                   "library_ms": time_ms(library), "bound_ms": bound_ms,
                   "bound_by": bound_by, "gflop": 4 * pairs * hq * d / 1e9}
            row["over_bound"] = row["ms"] / bound_ms
            rows.append(row)
            del q, kv, k, v, kc, vc, got, want, lib
    return rows


# (d, kind, shapes): the fused norm at the fixed-source families' widths,
# bf16: whisper-small's LayerNorm with bias (the encoder's 1500 frames a
# slot, a decode step) and the VLM's RMSNorm (a prefill wave, a step).
NORM_SOURCE = ((768, "layer", ((SLOTS, 1500, 768), (SLOTS, 1, 768))),
               (8192, "rms", ((SLOTS, PREFILL_PAD, 8192), (SLOTS, 1, 8192))))


def _norm_row(x, w, b_, r_, kind: str, eps: float) -> dict:
    """One fused-norm case: the kernel against its plain version (and its
    scalar body), timed beside F.rms_norm / F.layer_norm (without a
    residual), the plain version, the scalar body and the bound."""
    import torch.nn.functional as F

    from repro_torch.kernels.fused_norm import fused_norm as nk

    dtype, shape, d = x.dtype, tuple(x.shape), x.shape[-1]
    w_lib = w.to(dtype)                                   # F.* take x's type
    b_lib = b_.to(dtype) if b_ is not None else None
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
    e = check_close(f"norm {kind} {shape} {dtype}", got, plain(), dtype)
    launch = nk.launch_of(x, w, b_, r_, kind=kind)
    # The scalar body, the kernel as it ran before the vector one (a block
    # a row), timed on the same rows.
    scalar = nk.plan_launch(x.numel() // d, d, dtype, aligned=False)

    def kernel_scalar():
        return nk.fused_norm_cuda(x, w, b_, r_, launch=scalar, **kw)

    check_close(f"norm {kind} {shape} {dtype} scalar", kernel_scalar(),
                plain(), dtype)
    es = _esize(dtype)
    nbytes = (x.numel() * es * (3 if r_ is not None else 2)
              + 4 * d * (2 if b_ is not None else 1))
    ops = x.numel() * (8 if kind == "layer" else 5)
    t_b, t_o = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS[dtype]
    row = {"dtype": str(dtype).removeprefix("torch."),
           "shape": list(shape), "kind": kind,
           "residual": r_ is not None, "bias": b_ is not None,
           "body": launch.body, "tpr": launch.tpr,
           "rows_per_cta": launch.rows_per_cta, "ctas": launch.ctas,
           "err": e, "ms": time_ms(kernel),
           "scalar_ms": time_ms(kernel_scalar), "plain_ms": time_ms(plain),
           "library_ms": time_ms(library) if library else None,
           "bound_ms": max(t_b, t_o) * 1e3,
           "bound_by": "bytes" if t_b >= t_o else "operations"}
    row["over_bound"] = row["ms"] / row["bound_ms"]
    return row


def phase_norm(gpu: str, seed: int) -> dict:
    """Fused norm on the card at the prefill and decode shapes of yi-9b
    (d 4096): RMS with and without residual, LayerNorm with bias, against
    the plain version, timed against F.rms_norm / F.layer_norm and beside
    the scalar body on the same rows; then the fixed-source families'
    widths (NORM_SOURCE)."""
    gen = torch.Generator(device="cuda").manual_seed(seed + 20)
    d, eps = 4096, 1e-5
    rows, err, main = [], 0.0, {}
    for dtype in (torch.bfloat16, torch.float32):
        for shape in ((SLOTS, PREFILL_PAD, d), (SLOTS, 1, d)):
            x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
            r = torch.randn(shape, generator=gen, device="cuda").to(dtype)
            w = torch.randn(d, generator=gen, device="cuda")
            bias = torch.randn(d, generator=gen, device="cuda")
            for kind, b_, r_ in (("rms", None, None), ("rms", None, r),
                                 ("layer", bias, None)):
                row = _norm_row(x, w, b_, r_, kind, eps)
                err = max(err, row["err"])
                rows.append(row)
                if (dtype == torch.bfloat16 and shape[1] == PREFILL_PAD
                        and kind == "rms" and r_ is None):
                    main = row
    source = []
    for width, kind, shapes in NORM_SOURCE:
        w = torch.randn(width, generator=gen, device="cuda")
        bias = (torch.randn(width, generator=gen, device="cuda")
                if kind == "layer" else None)
        for shape in shapes:
            x = torch.randn(shape, generator=gen,
                            device="cuda").to(torch.bfloat16)
            source.append(_norm_row(x, w, bias, None, kind, eps))
    err = max([err] + [r["err"] for r in source])
    emit({"phase": "kernels_norm", "gpu": gpu, "rows": rows + source})
    return {"main": main, "err": err, "source": source}


# ---------------------------------------------------------------------------
# Phase 6: the SSD scan; phase 7: attention at zamba2's shapes
# ---------------------------------------------------------------------------

# (name, b, l, h, dh, g, ds): the two models' prefill shapes at the serve
# traffic's widest bucket, two grouped cases with ragged lengths (state 64
# and 128) and mamba2's heads at a one-row prefill.
SSD_CASES = (("mamba2", SLOTS, PREFILL_PAD, 64, 64, 1, 128),
             ("zamba2", SLOTS, PREFILL_PAD, 80, 64, 1, 64),
             ("grouped", 4, 300, 8, 64, 2, 64),
             ("grouped_ds128", 4, 333, 16, 64, 2, 128),
             ("l1", SLOTS, 1, 64, 64, 1, 128))


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


def _ssd_bound(dtype, b, l, h, dh, g, ds, init_state: bool = True):
    """Least time for one scan: x and B, C, dt read and y written once,
    the final state written once (fp32) and, with ``init_state``, the
    initial one read once, against the flops of the chunked algorithm at
    the kernel's 64-row tile (C B^T, the causal half of M x, C S and the
    state update) at the input type's peak."""
    es, q = _esize(dtype), 64
    nbytes = (2 * b * l * h * dh * es + 2 * b * l * g * ds * es
              + 4 * b * l * h + 8 * h
              + (2 if init_state else 1) * 4 * b * h * ds * dh)
    nc = -(-l // q)
    ops = b * h * nc * (2 * q * q * ds + q * (q + 1) * dh + 4 * q * ds * dh)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", ops / 1e9)


def phase_ssd(gpu: str, seed: int) -> dict:
    """The SSD kernel against its plain version (the reference's chunk
    rule), bf16 and fp32; parked slots' states bitwise; timed (bf16 and
    fp32 at the models' shapes) beside the bound and, for the mma body,
    the cuda_cores body on the same inputs."""
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
            launch = sk.launch_of(x, dt, A, B, C, D, init_state=S0)
            bound_ms, bound_by, gflop = _ssd_bound(dtype, b, l, h, dh, g, ds)
            row = {"case": name, "dtype": str(dtype).removeprefix("torch."),
                   "shape": [b, l, h, dh, g, ds], "body": launch.body,
                   "hb": launch.hb, "ctas": launch.ctas,
                   "threads": launch.threads, "smem": launch.smem,
                   "err": e,
                   "tol_used": {"y": tol_used(y, yp, dtype),
                                "state": tol_used(S, Sp, torch.float32)},
                   "parked_state_bitwise": True, "bound_ms": bound_ms,
                   "bound_by": bound_by, "gflop": gflop, "library_ms": None}
            if name in ("mamba2", "zamba2"):
                row |= {"ms": time_ms(kernel), "plain_ms": time_ms(plain,
                                                                   reps=5)}
                row["over_bound"] = row["ms"] / bound_ms
                if launch.body != "cuda_cores":
                    # The CUDA-core body on the same inputs: the kernel as
                    # it ran before the tensor-core one.
                    fma = sk.plan_launch(b, h, dh, g, ds, dtype,
                                         aligned=False)
                    row["cuda_cores_ms"] = time_ms(
                        lambda: sk.ssd_cuda(x, dt, A, B, C, D, init_state=S0,
                                            launch=fma))
            rows.append(row)
            if name == "mamba2" and dtype == torch.bfloat16:
                main = row
            del x, dt, B, C, S0, y, S, yp, Sp
    emit({"phase": "kernels_ssd", "gpu": gpu, "rows": rows,
          "kernel_chunk": sk.KERNEL_CHUNK})
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
               "body": fk.body(q, k, v),
               "shape": [SLOTS, hq, hkv, sq, sq, d], "causal": True, "err": e,
               "tol_used": tol_used(got, want, dtype),
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

# (name, e, c, k, n, counts, bf16 body): olmoe-1b-7b's expert products (64
# experts, d 2048, d_ff 1024) at the serve path's shapes: a dense-dispatch
# prefill wave (every expert multiplies all 16 x 1024 tokens) through
# wg/wu and through wd, a decode step (16 tokens), a sorted-dispatch
# wave's capacity buffers (16384 x 8 x 1.25 / 64 = 2560 rows an expert)
# with random counts, the reference test's ragged shape and a ragged k;
# then a prefill at 1000 rows an expert (no multiple of the wgmma body's
# 256-row tiles: the tensor maps' zero fill at c's edge) and a prefill-
# shaped buffer whose counts (GMM_TILE_COUNTS, expert by expert) are 0, c
# and inside a row tile: a dead CTA of a cluster, a dead warpgroup, one
# live row.  fp32 always takes the cuda_cores body.
GMM_CASES = (("prefill", 64, 16384, 2048, 1024, None, "wgmma"),
             ("prefill_wd", 64, 16384, 1024, 2048, None, "wgmma"),
             ("decode", 64, 16, 2048, 1024, None, "decode"),
             ("decode_wd", 64, 16, 1024, 2048, None, "decode"),
             ("sorted", 64, 2560, 2048, 1024, "random", "wgmma"),
             ("ragged", 8, 100, 200, 130, "random", "wmma"),
             ("ragged_k", 5, 77, 130, 96, "random", "wmma"),
             ("prefill_edge", 64, 1000, 2048, 1024, None, "wgmma"),
             ("prefill_counts", 64, 1536, 2048, 1024, "tiles", "wgmma"))
GMM_TILE_COUNTS = (0, 1536, 1, 127, 128, 129, 255, 700)


def phase_gmm(gpu: str, seed: int) -> dict:
    """The grouped GEMM against its plain version, bf16 and fp32, at
    olmoe's shapes; rows past each count exactly 0; a repeat bitwise; the
    body that ran (its launch counted by body) equal to the case's and to
    ``plan_launch``'s; timed beside its bound, the plain version and
    torch.bmm."""
    from repro_torch.kernels.moe_gmm import moe_gmm as gk

    gen = torch.Generator(device="cuda").manual_seed(seed + 50)
    rows, err, main = [], 0.0, {}
    for name, e, c, k, n, with_counts, body in GMM_CASES:
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.randn(e, c, k, generator=gen, device="cuda").to(dtype)
            w = (torch.randn(e, k, n, generator=gen, device="cuda")
                 * k ** -0.5).to(dtype)
            counts = None
            if with_counts == "random":
                counts = torch.randint(0, c + 1, (e,), generator=gen,
                                       device="cuda", dtype=torch.int32)
                counts[0], counts[1] = 0, c
            elif with_counts == "tiles":
                counts = torch.tensor(GMM_TILE_COUNTS, dtype=torch.int32,
                                      device="cuda").repeat(e // 8)

            def kernel():
                return gk.grouped_matmul_cuda(x, w, counts)

            def plain():
                return gk.grouped_matmul_plain(x, w, counts)

            def library():
                return torch.bmm(x, w)

            tag = f"gmm {name} {dtype}"
            gk.reset_counters()
            got = kernel()
            ran = [b for b, v in gk.grouped_matmul.body_launches.items() if v]
            planned = gk.plan_launch(
                e, c, k, n, dtype,
                strides=(x.stride(0), x.stride(1), w.stride(0), w.stride(1)),
                aligned=x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0)
            want_body = body if dtype == torch.bfloat16 else "cuda_cores"
            if ran != [planned] or planned != want_body:
                raise AssertionError(f"{tag}: ran {ran}, plan_launch says "
                                     f"{planned}, the case wants {want_body}")
            again, want = kernel(), plain()
            torch.cuda.synchronize()
            check_equal(f"{tag} repeat", got, again)
            del again
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
            grid = gk.grid_of(planned, e, c, n,
                              resident=gk.resident_ctas(x.device))
            row = {"case": name, "dtype": str(dtype).removeprefix("torch."),
                   "shape": [e, c, k, n],
                   "counts": None if counts is None else counts.tolist(),
                   "body": ran[0], "ctas": grid.ctas, "cluster": grid.cluster,
                   "err": e_k, "library_err": lib_err,
                   "rows_past_counts_zero": counts is not None,
                   "repeat_bitwise": True,
                   "ms": time_ms(kernel, **timing),
                   "plain_ms": time_ms(plain, reps=3, warm=1),
                   "library_ms": time_ms(library, **timing),
                   "bound_ms": max(t_bytes, t_ops) * 1e3,
                   "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                   "gflop": ops / 1e9}
            row["tflop_per_s"] = ops / row["ms"] / 1e9
            row["over_bound"] = row["ms"] / row["bound_ms"]
            row["library_over"] = row["ms"] / row["library_ms"]
            rows.append(row)
            if dtype == torch.bfloat16 and name in ("prefill", "decode"):
                main[name] = row
            del x, w, counts
            torch.cuda.empty_cache()
    emit({"phase": "kernels_gmm", "gpu": gpu, "rows": rows})
    return {"main": main["prefill"], "decode": main["decode"], "err": err}


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
    after, each output held against the plain version, the launches of
    each schedule equal to the plans'.  Then for each distinct schedule:
    mnk == nmk and a repeat bitwise, the body and launch the wrapper chose,
    the kernel's time (the split schedule's sum is inside the kernel)
    beside the plan's modeled time, the plain version, torch.matmul and the
    bound."""
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
    split = sum(sch["split_k"] > 1 for _, sch in plans.values())
    want_launches = {"matmul": len(plans) - split, "matmul_split": split}
    got = {key: launches[key] for key in want_launches}
    if got != want_launches or 0 in got.values():
        raise AssertionError(f"policy_matmul: launches {launches}, plans "
                             f"want {want_launches} (both nonzero)")

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
                launch = mk.launch_of(a, b, **schedule)
                ms = time_ms(kernel)
                measured[key] = {
                    "body": launch.body, "tile": list(launch.tile),
                    "ctas": launch.ctas, "cluster": launch.cluster,
                    "kslice": launch.kslice, "ms": ms,
                    "tflops": 2 * m * n * k / ms / 1e9,
                    "gb_per_s": (m * k + k * n + m * n) * es / ms / 1e6,
                    "over_bound": ms / bound["bound_ms"],
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
        modeled = min(shape_rows, key=lambda r: r["modeled_ms"])
        adaptive = next(r for r in shape_rows
                        if r["mode"] == "adaptive" and r["rinse"])
        summary.append({
            "shape": name, "fastest_mode": [fastest["mode"],
                                            fastest["rinse"]],
            "fastest_ms": fastest["ms"], "fastest_out": fastest["out"],
            "adaptive_ms": adaptive["ms"], "adaptive_out": adaptive["out"],
            "adaptive_over_fastest": adaptive["ms"] / fastest["ms"],
            "modeled_fastest_mode": [modeled["mode"], modeled["rinse"]],
            "adaptive_modeled_ms": adaptive["modeled_ms"],
            "bodies": sorted({r["body"] for r in shape_rows}),
            "schedules": len(measured), "library_ms": library_ms,
            **bound})
        del a, b
        torch.cuda.empty_cache()
    emit({"phase": "policy_matmul", "gpu": gpu, "launch_counts": launches,
          "main_path_s": main_s, "phase_s": time.perf_counter() - t0,
          "want_launches": want_launches,
          "tf32": torch.backends.cuda.matmul.allow_tf32, "rows": rows})
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


def _serve(cfg, params, reqs, n_pages=None, cuda_graph=True,
           check_replay=True, chunk_size: int = 8, prepare=None,
           extras=None) -> dict:
    """Serve ``reqs`` on a fresh engine (its decode chunk captured as a
    CUDA graph at construction unless ``cuda_graph`` is False), with every
    kernel counter zeroed just before the run and read just after it;
    ``prepare(engine)``, if given, runs after construction; ``extras``
    gives the slots' sources (encoder frames, vision tokens).  Returns the
    wall time, each chunk's seconds, ``serve_stats()``, the pages still
    held, the quarantined ones, the counts, the peak memory (allocated and
    reserved, the graph's pool included) from construction to drain and,
    graphed with ``check_replay``, one replay's kernels, each checked
    against its captured count (check_replay_kernels)."""
    from repro_torch.serve.engine import ServeEngine

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    eng = ServeEngine(cfg, params, batch_slots=SLOTS, max_len=MAX_LEN,
                      chunk_size=chunk_size, n_pages=n_pages,
                      cuda_graph=cuda_graph, extras=extras)
    chunk_s = []
    run_chunk = eng._run_chunk

    def timed_chunk():
        t0 = time.perf_counter()
        run_chunk()            # ends in the chunk's device-to-host copy
        chunk_s.append(time.perf_counter() - t0)

    eng._run_chunk = timed_chunk
    if prepare is not None:
        prepare(eng)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = counts()
    stats = eng.serve_stats() | {"paged": eng.paged,
                                 "decode_splits": eng.decode_splits,
                                 "rounds_per_chunk": eng.spec_rounds}
    if stats["graph_replays"] != (stats["chunks"] if cuda_graph else 0):
        raise AssertionError(f"{cfg.arch}: {stats['graph_replays']} graph "
                             f"replays for {stats['chunks']} chunks "
                             f"(cuda_graph={cuda_graph})")
    held = (eng.n_pages - eng.allocator.free_count()) if eng.paged else 0
    quarantined = (sorted(eng.allocator.quarantined_pages) if eng.paged
                   else [])
    eng.check_invariants()
    peak = {"peak_allocated": torch.cuda.max_memory_allocated(),
            "peak_reserved": torch.cuda.max_memory_reserved()}
    replay = (check_replay_kernels(cfg.arch, eng)
              if cuda_graph and check_replay else None)
    del eng
    return {"wall": wall, "chunk_s": chunk_s, "stats": stats, "held": held,
            "quarantined": quarantined, "counts": got,
            "replay_kernels": replay, **peak}


# The CUDA kernels behind each launch counter, by symbol: one wrapper call
# is one launch of one of them.  A graph replay runs no Python, so a
# graphed engine adds the capture's launches to the counters per replay;
# check_replay_kernels holds that to the kernels the profiler sees.
REPLAY_SYMBOLS = {
    "decode": (r"\bsplit_kv_decode_kernel\b",
               ("paged_decode_attention.launches",
                "decode_attention.launches")),
    "flash": (r"\bflash_(simt|mma)_kernel\b",
              ("flash_attention.launches", "paged_flash_attention.launches")),
    "fused_norm": (r"\bfused_norm(_vec)?_kernel\b", ("fused_norm.launches",)),
    "ssd": (r"\bssd_(fma|mma)_kernel\b", ("ssd.launches",)),
    "grouped_matmul": (r"\bgmm_(f32|(wmma|wgmma|decode)_kernel)\b",
                       ("grouped_matmul.launches",)),
    "gmm_cuda_cores": (r"\bgmm_f32\b",
                       ("grouped_matmul.body_launches[cuda_cores]",)),
    "gmm_wmma": (r"\bgmm_wmma_kernel\b",
                 ("grouped_matmul.body_launches[wmma]",)),
    "gmm_wgmma": (r"\bgmm_wgmma_kernel\b",
                  ("grouped_matmul.body_launches[wgmma]",)),
    "gmm_decode": (r"\bgmm_decode_kernel\b",
                   ("grouped_matmul.body_launches[decode]",)),
    "matmul": (r"\bmm_(wgmma|small|wmma|fma)_kernel\b",
               ("matmul.launches", "matmul.splitk_launches")),
}


def check_replay_kernels(arch: str, eng) -> dict:
    """Profile three replays of ``eng``'s captured chunk with a spin kernel
    between each two (after its run every slot is parked, so a replay
    changes no state) and require, for each kernel, as many launches in
    the middle replay as its counters took at the capture: the count each
    replay adds to them.  The profiler can lose device events at the edges
    of its window (on the card, the first few and up to a few hundred of
    the last), hence the replays around the one counted.  Returns
    {kernel: launches in the middle replay}."""
    from torch.profiler import ProfilerActivity, profile

    delta = eng._graph_delta
    mapped = {n for _, names in REPLAY_SYMBOLS.values() for n in names}
    unmapped = [n for n in delta if not n.endswith(".calls")
                and n not in mapped]
    if unmapped:
        raise AssertionError(f"{arch}: no kernel symbol for the captured "
                             f"counters {unmapped}")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(3):
            if i:
                torch.cuda._sleep(1_000_000)        # the marker kernel
            eng._graph.replay()
        torch.cuda.synchronize()
    # The raw events, in device order: parsing them into FunctionEvents
    # takes seconds for a replay's 40000.
    events = sorted(
        ((e.start_ns(), e.name())
         for e in prof.profiler.kineto_results.events()
         if e.device_type() == torch.autograd.DeviceType.CUDA))
    names = [name for _, name in events]
    marks = [i for i, name in enumerate(names)
             if re.search(r"\bspin_kernel\b", name)]
    if len(marks) != 2 or marks[1] - marks[0] < 2:
        raise AssertionError(f"{arch}: the profiler saw the marker kernels "
                             f"at {marks} of {len(names)} device events")
    middle = names[marks[0] + 1:marks[1]]
    seen = {}
    for kernel, (pattern, counted) in REPLAY_SYMBOLS.items():
        n = sum(1 for name in middle if re.search(pattern, name))
        want = sum(delta.get(c, 0) for c in counted)
        if n != want:
            raise AssertionError(f"{arch}: one graph replay launched {n} "
                                 f"{kernel} kernels; the capture counted "
                                 f"{want}")
        if n:
            seen[kernel] = n
    return seen | {"device_events": len(middle)}


def _graph_fields(run: dict) -> dict:
    """A run's chunk time, graph replays and memory, for its phase line."""
    stats = run["stats"]
    return {"ms_per_chunk": 1e3 * statistics.mean(run["chunk_s"]),
            "ms_per_chunk_median": 1e3 * statistics.median(run["chunk_s"]),
            "graph_replays": stats["graph_replays"],
            "captured_launches": stats["captured_launches"],
            "replay_kernels": run["replay_kernels"],
            "graph_pool_bytes": stats["graph_pool_bytes"],
            "max_memory_allocated": run["peak_allocated"],
            "max_memory_reserved": run["peak_reserved"]}


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
    zamba2, none of mamba2's; whisper's and the VLM's self layers read the
    page pool (paged kernels under pallas_paged) and their cross layers
    the fixed-source K/V (dense kernels on every route), and a whisper
    decoder layer has three norms.  A speculative chunk has no decode
    step: each of its rounds is one prefill (the verify), two under a
    replay rollback (recurrent families).  The encoder's launches run at
    the engine's construction, before the counters are zeroed."""
    waves, steps = stats["admission_waves"], stats["chunks"] * 8
    if cfg.spec_k:
        replay = 2 if cfg.family in ("ssm", "hybrid") else 1
        waves += stats["chunks"] * stats["rounds_per_chunk"] * replay
        steps = 0
    L = cfg.n_layers
    g = L // max(cfg.cross_attn_every, 1)
    # (self-attention layers, cross layers, Mamba-2 layers)
    attn, cross, ssm = {
        "dense": (L, 0, 0), "moe": (L, 0, 0), "ssm": (0, 0, L),
        "hybrid": (L // max(cfg.shared_attn_every, 1), 0, L),
        "encdec": (L, L, 0), "vlm": (L - g, g, 0)}[cfg.family]
    norms = (3 * L if cfg.family == "encdec"
             else 2 * (attn + cross) + ssm) + 1
    moe = L if cfg.family == "moe" else 0
    paged = cfg.decode_kernel == "pallas_paged"
    want = {"decode_paged": attn * steps if paged else 0,
            "decode_dense": (cross if paged else attn + cross) * steps,
            "flash_paged": attn * waves if paged else 0,
            "flash_dense": (cross if paged else attn + cross) * waves,
            "fused_norm": norms * (waves + steps),
            "ssd": ssm * waves,
            "grouped_matmul": 3 * moe * (waves + steps), "matmul": 0,
            "matmul_split": 0, "plain": 0}
    if got != want:
        raise AssertionError(f"{arm} arm: launch counts {got} != {want}")


def check_gmm_bodies(arm: str, cfg, stats: dict) -> dict:
    """A MoE arm's grouped-GEMM launches by body: a wave's products (16
    slots x the pad, over 64 rows an expert) run the wgmma body, a decode
    step's (16 rows) the decode body, three a MoE layer each."""
    from repro_torch.kernels.moe_gmm import moe_gmm as gk

    got = dict(gk.grouped_matmul.body_launches)
    per = 3 * cfg.n_layers
    want = {"cuda_cores": 0, "wmma": 0,
            "wgmma": per * stats["admission_waves"],
            "decode": per * stats["chunks"] * 8}
    if got != want:
        raise AssertionError(f"{arm} arm: grouped GEMM launches by body "
                             f"{got} != {want}")
    return got


def check_streams(arm: str, reqs, cfg) -> None:
    for r in reqs:
        if len(r.generated) != r.max_new_tokens or not all(
                0 <= t < cfg.padded_vocab for t in r.generated):
            raise AssertionError(f"{arm} arm: request {r.id}: bad stream")


def _time_source(eng, into: dict) -> None:
    """A ``_serve`` prepare hook for the fixed-source families: the
    median of three runs of the engine's ``fill_source`` (whisper's
    encoder and every layer's cross projection, or the VLM's vision
    projection and cross K/V, for all slots; host clock around synchronised
    work) as ``encode_ms``, and the cross K/V's bytes.  It rewrites the
    buffers in place before the counters are zeroed."""
    from repro_torch.serve.engine import _leaves

    ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.inference_mode():
            eng.model.fill_source(eng.params, eng.cache, **eng.extras)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
    into["encode_ms"] = statistics.median(ms)
    into["cross_kv_bytes"] = sum(t.nbytes for path, t in _leaves(eng.cache)
                                 if "cross" in path)


def _source_extras(cfg, seed: int) -> dict | None:
    """Each slot's source for a fixed-source family, drawn from the seed on
    the card in the model's dtype: whisper's encoder frames (slots,
    enc_seq, d) or the VLM's vision tokens (slots, n_vis, d); None for
    the other families."""
    from repro_torch.device import torch_dtype

    if cfg.family not in ("encdec", "vlm"):
        return None
    gen = torch.Generator(device="cuda").manual_seed(seed + 40)
    n = cfg.enc_seq if cfg.family == "encdec" else cfg.n_vis_tokens
    x = torch.randn(SLOTS, n, cfg.d_model, generator=gen, device="cuda")
    return {"frames" if cfg.family == "encdec" else "vis":
            x.to(torch_dtype(cfg.dtype))}


def phase_serve(gpu: str, seed: int, cfg, name: str = "serve",
                twins=("eager", "gather"), trace: bool = True,
                cut: str | None = None) -> dict:
    """Serve the 48 requests at ``cfg`` (a paged pallas_paged config), the
    decode chunks as CUDA graph replays, with every launch count checked
    and one replay's kernels held to the capture's counts; with
    ``"eager"`` in ``twins``, then the first 16 with the graph off (the
    eager loop: streams bitwise equal) and with ``"gather"``, for a model
    with attention, under pallas_gather (streams bitwise equal); with
    ``trace``, then the
    decode-chunk (graph on and off) and admission-wave trace, whose
    chunk pair's wall time, idle share and peak memory the arm's line
    carries as ``graph_on_off`` ([on, off]).  A fixed-source family
    (whisper, the VLM) serves with each slot's source from the seed
    (``_source_extras``), and its line carries ``encode_ms`` and
    ``cross_kv_bytes`` (``_time_source``); ``cut`` says how its config
    was cut to fit the card."""
    from repro_torch import convert
    from repro_torch.serve.engine import Request

    gen = torch.Generator(device="cuda").manual_seed(seed)
    t0 = time.perf_counter()
    params = convert.init(cfg, gen, "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    extras = _source_extras(cfg, seed)
    # Warm-up (cuBLAS handles, allocator): two short requests.
    warm = [Request(prompt=np.arange(40, dtype=np.int32), max_new_tokens=9),
            Request(prompt=np.arange(9, dtype=np.int32), max_new_tokens=3)]
    _serve(cfg, params, warm, check_replay=False, extras=extras)

    # Each arm's counts are zeroed just before its run and read just after
    # (inside _serve).
    reqs = _requests(Request, cfg.vocab, seed)
    source = {}
    run = _serve(cfg, params, reqs, extras=extras,   # the paged main path
                 prepare=(lambda eng: _time_source(eng, source))
                 if extras else None)
    stats, counts_paged = run["stats"], run["counts"]
    check_counts(name, counts_paged, cfg, stats)
    check_streams(name, reqs, cfg)
    moe = cfg.family == "moe"
    gmm_bodies = check_gmm_bodies(name, cfg, stats) if moe else None
    if cfg.n_heads and stats["decode_splits"] != planned_splits(
            cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_):
        raise AssertionError(f"{name}: the engine baked "
                             f"{stats['decode_splits']} decode splits, not "
                             "its policy engine's plan")
    if cfg.family == "ssm" and stats["paged"]:
        raise AssertionError(f"{name}: a cache with no pages must run "
                             "contiguous bookkeeping")
    tokens = sum(len(r.generated) for r in reqs)
    line = {
        "phase": name, "gpu": gpu, "arch": cfg.arch,
        "n_layers": cfg.n_layers, "dtype": cfg.dtype,
        "params": cfg.param_count(), "init_s": init_s,
        "requests": len(reqs), "tokens": tokens, "wall_s": run["wall"],
        "tok_per_s": tokens / run["wall"],
        "mean_ttft_ms": 1e3 * statistics.mean(r.ttft_s for r in reqs),
        **_graph_fields(run),
        "decode_steps": stats["chunks"] * 8,
        "host_syncs": stats["host_syncs"],
        "host_syncs_per_token": stats["host_syncs_per_token"],
        "admission_waves": stats["admission_waves"],
        "engine_paged": stats["paged"],
        "decode_splits": stats["decode_splits"],
        "peak_pages_held": stats["peak_pages_held"],
        "launch_counts": counts_paged,
        **source,
    }
    if cut:
        line["cut"] = cut
    out = {"cfg": cfg, "params": params, "launches": counts_paged,
           "reqs": reqs}
    if moe:
        line["gmm_body_launches"] = out["gmm_bodies"] = gmm_bodies
    if "eager" in twins:
        # The graph off over the first 16 requests (the first wave's): the
        # same kernels launched by the eager loop, streams bitwise equal.
        # Each slot's arithmetic does not depend on what the other slots
        # hold; the trace times both from one state.
        ereqs = _requests(Request, cfg.vocab, seed)[:SLOTS]
        erun = _serve(cfg, params, ereqs, cuda_graph=False, extras=extras)
        check_counts(name + " eager", erun["counts"], cfg, erun["stats"])
        if moe:
            check_gmm_bodies(name + " eager", cfg, erun["stats"])
        if [r.generated for r in ereqs] != [r.generated
                                             for r in reqs[:SLOTS]]:
            raise AssertionError(f"{name}: the eager loop's streams differ "
                                 "from the graph's")
        etokens = sum(len(r.generated) for r in ereqs)
        line["eager"] = {"requests": len(ereqs), "tokens": etokens,
                         "wall_s": erun["wall"],
                         "tok_per_s": etokens / erun["wall"],
                         **_graph_fields(erun),
                         "host_syncs_per_token":
                             erun["stats"]["host_syncs_per_token"],
                         "mean_ttft_ms": 1e3 * statistics.mean(
                             r.ttft_s for r in ereqs),
                         "launch_counts": erun["counts"],
                         "streams_equal": True}
    # The pallas_gather twin over the same first 16 requests.
    if "gather" in twins and cfg.n_heads:
        gcfg = dataclasses.replace(cfg, decode_kernel="pallas_gather")
        greqs = _requests(Request, cfg.vocab, seed)[:SLOTS]
        grun = _serve(gcfg, params, greqs,      # the pallas_gather path
                      extras=extras)
        check_counts(name + " gather", grun["counts"], gcfg,
                     grun["stats"])
        if moe:
            check_gmm_bodies(name + " gather", gcfg, grun["stats"])
        if [r.generated for r in greqs] != [r.generated
                                             for r in reqs[:SLOTS]]:
            raise AssertionError(f"{name}: pallas_gather streams differ "
                                 "from pallas_paged")
        gtokens = sum(len(r.generated) for r in greqs)
        line["gather"] = {"requests": len(greqs), "tokens": gtokens,
                          "wall_s": grun["wall"],
                          "tok_per_s": gtokens / grun["wall"],
                          "ms_per_chunk":
                              1e3 * statistics.mean(grun["chunk_s"]),
                          "replay_kernels": grun["replay_kernels"],
                          "launch_counts": grun["counts"],
                          "streams_equal": True}
        out["gather_launches"] = grun["counts"]
    if trace:
        # The graph on and off from one state (the trace's chunk pair).
        tr = phase_trace(gpu, cfg, params, seed, extras)
        line["graph_on_off"] = {
            key: [tr["chunk"][key], tr["chunk_eager"][key]]
            for key in ("wall_ms", "device_idle_share",
                        "max_memory_allocated", "max_memory_reserved")}
    emit(line)
    return out


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


def phase_trace(gpu: str, cfg, params, seed: int, extras=None) -> dict:
    """One decode chunk at full width (16 slots of 512 prompt tokens) with
    the graph on (one replay) and off (the eager loop) from the same
    state, then one admission wave (16 prompts of 1000 tokens, pad 1024),
    each timed untraced and then traced with torch.profiler: device busy
    time, idle share, the kernels that take the time and, for the replay,
    every device event (kernels and copies) the profiler sees inside it,
    by name with its count; each chunk's engine with its peak memory from
    construction (the graph's pool included)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serve.engine import Request, ServeEngine

    rng = np.random.default_rng(seed + 2)
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    chunk_prompts = [rng.integers(0, cfg.vocab, 512).astype(np.int32)
                     for _ in range(SLOTS)]
    chunks = {}
    for graph in (True, False):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        eng = ServeEngine(cfg, params, batch_slots=SLOTS, max_len=MAX_LEN,
                          chunk_size=8, cuda_graph=graph, extras=extras)
        eng.submit([Request(prompt=p, max_new_tokens=25)
                    for p in chunk_prompts])
        eng.step()                  # admission wave + one warm chunk
        t0 = time.perf_counter()
        eng._run_chunk()            # ends in the chunk's device-to-host copy
        wall = time.perf_counter() - t0
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            eng._run_chunk()        # the last: every budget runs out
            traced_wall = time.perf_counter() - t0
        rows = _profile_rows(prof)
        chunks[graph] = _trace_line(
            "decode_chunk" if graph else "decode_chunk_eager", wall,
            traced_wall, rows) | {
                "max_memory_allocated": torch.cuda.max_memory_allocated(),
                "max_memory_reserved": torch.cuda.max_memory_reserved()}
        if graph:
            chunks[graph]["kernels_seen"] = sum(c for _, _, c in rows)
            chunks[graph]["kernel_counts"] = {k[:80]: c for _, k, c in rows}
            del eng

    def prompts(n_tokens, budget):
        return [Request(prompt=rng.integers(0, cfg.vocab, n_tokens).astype(
            np.int32), max_new_tokens=budget) for _ in range(SLOTS)]

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
    del eng
    line = {"phase": "trace", "gpu": gpu, "arch": cfg.arch,
            "chunk_steps": 8, "wave_slots": SLOTS, "wave_prompt": 1000,
            "chunk": chunks[True], "chunk_eager": chunks[False],
            "wave": wave}
    emit(line)
    return line


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


def _cut_depth(cfg, params, n_layers: int):
    """``cfg`` and ``params`` cut to their first ``n_layers`` layers (a
    dense or hybrid model; the layer list is sliced, nothing copied)."""
    return (dataclasses.replace(cfg, n_layers=n_layers),
            {**params, "layers": params["layers"][:n_layers]})


def phase_prefix(gpu: str, seed: int, cfg, params,
                 cut: str | None = None) -> None:
    """Serve the shared-prompt traffic with prefix sharing and preemption
    over a 256-page pool, invariants checked after every wave; then the
    same requests with sharing off."""
    from repro_torch.serve.engine import Request

    pcfg = dataclasses.replace(cfg, prefix_sharing=True, preemption=True,
                               strict_invariants=True)
    reqs = _prefix_requests(Request, cfg.vocab, seed)
    run = _serve(pcfg, params, reqs, n_pages=PREFIX_POOL)   # the prefix arm
    stats, held, got = run["stats"], run["held"], run["counts"]
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
    orun = _serve(ocfg, params, oreqs, n_pages=PREFIX_POOL)
    owall, ostats, oheld = orun["wall"], orun["stats"], orun["held"]
    wall = run["wall"]
    check_streams("sharing-off", oreqs, ocfg)
    equal = sum(a.generated == b.generated for a, b in zip(reqs, oreqs))
    first_equal = sum(a.generated[0] == b.generated[0]
                      for a, b in zip(reqs, oreqs))
    emit({"phase": "prefix", "gpu": gpu, "arch": cfg.arch,
          "n_layers": cfg.n_layers, "cut": cut, "dtype": cfg.dtype,
          "requests": len(reqs), "pool_pages": PREFIX_POOL,
          "tokens": tokens, "wall_s": wall, "tok_per_s": tokens / wall,
          "mean_ttft_ms": 1e3 * statistics.mean(r.ttft_s for r in reqs),
          "ms_per_chunk": 1e3 * statistics.mean(run["chunk_s"]),
          "graph_replays": stats["graph_replays"],
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
    run = _serve(pcfg, params, reqs, n_pages=PREFIX_POOL)  # the preempt arm
    stats, held, got = run["stats"], run["held"], run["counts"]
    wall, chunk_s = run["wall"], run["chunk_s"]
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
          "graph_replays": stats["graph_replays"],
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
# Speculative decode and the adaptive serve-tier policy
# ---------------------------------------------------------------------------

SPEC_K, SPEC_NGRAM = 4, 3   # drafts a round, the proposer's suffix
SPEC_CHUNK = 10             # two rounds of k + 1 = 5 a graph replay
SPEC_PROBES, SPEC_PROMPT = 64, 64
SPEC_CUT, SPEC_NEW = 256, 128


def _ngram_oracle(hist: list, start: int, g: int, k: int) -> float:
    """benchmarks/serve_bench.py's ``_ngram_oracle``: the simulated draft
    acceptance of ``hist[start:]`` (suffix match of ``g`` tokens, the last
    earlier occurrence wins, ``k`` drafts), with each n-gram's last start
    kept in a dict instead of rescanned."""
    last, indexed, acc, tot, i = {}, 0, 0, 0, start
    while i < len(hist):
        while indexed < i - g:
            last[tuple(hist[indexed:indexed + g])] = indexed
            indexed += 1
        best = last.get(tuple(hist[i - g:i]), -1)
        a = 0
        for j in range(k):
            q = best + g + j
            d = hist[q] if best >= 0 and q < i else hist[i - 1]
            if i + j < len(hist) and d == hist[i + j]:
                a += 1
            else:
                break
        acc += a
        tot += k
        i += a + 1
    return acc / tot if tot else 0.0


def _spec_workload(cfg, params, seed: int, probes: int = SPEC_PROBES,
                   cut: int = SPEC_CUT, new: int = SPEC_NEW):
    """serve_bench's spec recipe at this arm's size: greedy streams of
    ``probes`` seeded 64-token prompts from the plain graphed engine, their
    tails ranked by the n-gram oracle, the SLOTS most repetitive resumed
    ``cut`` tokens in to decode ``new``.  Returns (a factory of fresh
    request lists, the probe's numbers)."""
    from repro_torch.serve.engine import Request

    rng = np.random.default_rng(seed + 7)
    prompts = [rng.integers(0, cfg.vocab, SPEC_PROMPT).astype(np.int32)
               for _ in range(probes)]
    probe = [Request(prompt=p, max_new_tokens=cut + new) for p in prompts]
    run = _serve(cfg, params, probe, check_replay=False)
    scored = sorted(
        ((_ngram_oracle(list(p) + r.generated, len(p) + cut, SPEC_NGRAM,
                        SPEC_K), i) for i, (p, r) in enumerate(zip(prompts,
                                                                 probe))),
        key=lambda t: (-t[0], t[1]))[:SLOTS]

    def requests():
        return [Request(prompt=np.concatenate(
            [prompts[i], np.asarray(probe[i].generated[:cut], np.int32)]),
            max_new_tokens=new) for _, i in scored]

    return requests, {"probes": probes, "probe_wall_s": run["wall"],
                      "oracle_acceptance": [a for a, _ in scored]}


def _run_line(reqs, run: dict) -> dict:
    tokens = sum(len(r.generated) for r in reqs)
    stats = run["stats"]
    return {"requests": len(reqs), "tokens": tokens, "wall_s": run["wall"],
            "tok_per_s": tokens / run["wall"],
            "mean_ttft_ms": 1e3 * statistics.mean(r.ttft_s for r in reqs),
            "chunks": stats["chunks"],
            "host_syncs_per_token": stats["host_syncs_per_token"],
            **_graph_fields(run), "launch_counts": run["counts"]}


def _trace_spec_chunk(cfg, params, reqs, skip: int = 7) -> dict:
    """One graphed speculative chunk mid-decode: the requests admitted
    (one wave and one chunk), ``skip`` more chunks, then one chunk timed
    untraced and the next traced with torch.profiler: device busy time,
    idle share, the kernels that take the time, the flash kernel's (the
    verify's attention) share of the device time, and the slots' cursor
    range at the traced chunk.  Every slot is still decoding there (at
    most 2 (k + 1) tokens a chunk)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serve.engine import ServeEngine

    eng = ServeEngine(cfg, params, batch_slots=SLOTS, max_len=MAX_LEN,
                      chunk_size=SPEC_CHUNK)
    eng.submit(reqs)
    eng.step()
    for _ in range(skip):
        eng._run_chunk()
    lengths = eng.cache["lengths"].tolist()
    t0 = time.perf_counter()
    eng._run_chunk()            # ends in the chunk's device-to-host copy
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng._run_chunk()
        traced_wall = time.perf_counter() - t0
    if any(r is None for r in eng.slot_req):
        raise AssertionError(f"{cfg.arch}: a slot finished before the "
                             "traced speculative chunk")
    del eng
    rows = _profile_rows(prof)
    line = _trace_line("spec_chunk", wall, traced_wall, rows)
    flash = [(us, c) for us, k, c in rows
             if re.search(REPLAY_SYMBOLS["flash"][0], k)]
    flash_ms = sum(us for us, _ in flash) / 1e3
    busy = line["device_busy_ms"]
    return line | {"kv_len_range": [min(lengths), max(lengths)],
                   "flash_ms": flash_ms,
                   "flash_launches": sum(c for _, c in flash),
                   "flash_share": flash_ms / busy if busy else None}


def phase_serve_spec(gpu: str, seed: int, cfg, params, name: str,
                     cut: str | None = None) -> dict:
    """Speculative decode at ``cfg`` (a paged pallas_paged config) on
    serve_bench's repeat-heavy recipe: the plain graphed engine's tok/s,
    then the speculative chunk (spec_k 4, n-gram 3, two rounds a graph
    replay) with its launch counts checked and one replay's kernels held
    to the capture's, then its eager twin, streams bitwise equal to the
    graph's.  Streams equal to the plain engine's are counted, not
    required (bf16: the verify pass is a prefill at other shapes)."""
    requests, probe = _spec_workload(cfg, params, seed)
    plain_reqs = requests()
    prun = _serve(cfg, params, plain_reqs)
    scfg = dataclasses.replace(cfg, spec_k=SPEC_K, spec_ngram=SPEC_NGRAM)
    reqs = requests()
    run = _serve(scfg, params, reqs, chunk_size=SPEC_CHUNK)  # the spec path
    stats = run["stats"]
    check_counts(name, run["counts"], scfg, stats)
    check_streams(name, reqs, scfg)
    ereqs = requests()
    erun = _serve(scfg, params, ereqs, cuda_graph=False,
                  chunk_size=SPEC_CHUNK)
    check_counts(name + " eager", erun["counts"], scfg, erun["stats"])
    if [r.generated for r in ereqs] != [r.generated for r in reqs]:
        raise AssertionError(f"{name}: the eager speculative chunk's streams "
                             "differ from the graph's")
    trace = _trace_spec_chunk(scfg, params, requests())
    line = {"phase": name, "gpu": gpu, "arch": cfg.arch,
            "n_layers": cfg.n_layers, "cut": cut, "dtype": cfg.dtype,
            "spec_k": SPEC_K, "spec_ngram": SPEC_NGRAM,
            "chunk_size": SPEC_CHUNK,
            "rounds_per_chunk": stats["rounds_per_chunk"],
            "prompt": SPEC_PROMPT + SPEC_CUT, "new_tokens": SPEC_NEW,
            "probe": probe,
            "spec_acceptance_rate": stats["spec_acceptance_rate"],
            "spec_tokens_per_round": stats["spec_tokens_per_round"],
            "spec_rounds": stats["spec_rounds"],
            "draft_proposed": stats["draft_proposed"],
            "draft_accepted": stats["draft_accepted"],
            **_run_line(reqs, run),
            "plain": _run_line(plain_reqs, prun),
            "streams_equal_plain": sum(a.generated == b.generated
                                       for a, b in zip(reqs, plain_reqs)),
            "first_tokens_equal_plain": sum(
                a.generated[0] == b.generated[0]
                for a, b in zip(reqs, plain_reqs)),
            "eager": {**_run_line(ereqs, erun), "streams_equal": True,
                      "spec_acceptance_rate":
                          erun["stats"]["spec_acceptance_rate"]},
            "trace": trace}
    line["speedup_over_plain"] = (line["tok_per_s"]
                                  / line["plain"]["tok_per_s"])
    line["streams_equal_plain_share"] = (line["streams_equal_plain"]
                                         / len(reqs))
    emit(line)
    return {"launches": run["counts"]}


def _oracle_proposer(seqs, vocab: int, device):
    """A drop-in for ``ngram_propose`` that drafts the known greedy
    continuation: ``seqs[i]`` is request i's prompt and plain stream, the
    request found by its history's first token (i); the last draft of a
    slot whose history length is a multiple of 3 is spoiled, so every
    acceptance length occurs.  Static shapes, device tensors: capturable."""
    width = max(len(q) for q in seqs)
    table = torch.zeros((len(seqs), width), dtype=torch.int32, device=device)
    for i, q in enumerate(seqs):
        table[i, :len(q)] = torch.tensor(q, dtype=torch.int32)

    def propose(hist, hist_len, ngram, k):
        cols = torch.arange(k, device=hist.device)
        pos = (hist_len[:, None] + cols[None]).clamp(max=width - 1).long()
        rows = hist[:, 0].clamp(0, len(seqs) - 1).long()
        drafts = table[rows[:, None], pos]
        spoil = (hist_len % 3 == 0)[:, None] & (cols == k - 1)[None]
        return torch.where(spoil, (drafts + 1) % vocab, drafts)

    return propose


def phase_spec_identity(seed: int, base, n_layers: int) -> dict:
    """fp32 at ``base``'s width cut to ``n_layers``: the speculative
    engine's 16 streams (graphed) bitwise equal to the plain engine's, on
    the spec recipe at a quarter of its probes and half its lengths (each
    prompt's first token set to its index), with the n-gram proposer and
    then with an oracle proposer drafting the plain streams (random weights
    need not repeat, so the n-gram leg may accept few drafts; the oracle
    leg must accept, and the rollback then runs after every acceptance
    length)."""
    import repro_torch.serve.engine as engine_mod
    from repro_torch import convert

    cfg = dataclasses.replace(base, n_layers=n_layers, dtype="float32")
    gen = torch.Generator(device="cuda").manual_seed(seed + 21)
    params = convert.init(cfg, gen, "cuda")
    requests, probe = _spec_workload(
        cfg, params, seed, probes=SPEC_PROBES // 4, cut=SPEC_CUT // 2,
        new=SPEC_NEW // 2)

    def numbered():
        reqs = requests()
        for i, r in enumerate(reqs):
            r.prompt[0] = i
        return reqs

    plain_reqs = numbered()
    _serve(cfg, params, plain_reqs, check_replay=False)
    scfg = dataclasses.replace(cfg, spec_k=SPEC_K, spec_ngram=SPEC_NGRAM)
    row = {"arch": cfg.arch, "n_layers": n_layers, "dtype": "float32",
           "rollback": "replay" if cfg.family in ("ssm", "hybrid")
           else "rewind", "requests": len(plain_reqs),
           "oracle_acceptance_mean": statistics.mean(
               probe["oracle_acceptance"])}
    ngram_propose = engine_mod.ngram_propose
    for leg in ("ngram", "oracle"):
        if leg == "oracle":
            engine_mod.ngram_propose = _oracle_proposer(
                [list(r.prompt) + r.generated for r in plain_reqs], cfg.vocab,
                params["embed"]["tok"].device)
        try:
            reqs = numbered()
            run = _serve(scfg, params, reqs, chunk_size=SPEC_CHUNK)
        finally:
            engine_mod.ngram_propose = ngram_propose
        stats = run["stats"]
        check_counts(f"spec_identity {cfg.arch} {leg}", run["counts"], scfg,
                     stats)
        equal = sum(a.generated == b.generated
                    for a, b in zip(reqs, plain_reqs))
        row[leg] = {"streams_equal_plain": equal,
                    "spec_acceptance_rate": stats["spec_acceptance_rate"],
                    "spec_tokens_per_round": stats["spec_tokens_per_round"],
                    "draft_accepted": stats["draft_accepted"],
                    "graph_replays": stats["graph_replays"],
                    "replay_kernels": run["replay_kernels"]}
        if equal != len(reqs):
            raise AssertionError(f"spec_identity {cfg.arch} {leg}: {equal} "
                                 f"of {len(reqs)} fp32 spec streams equal "
                                 "plain")
    if row["oracle"]["draft_accepted"] <= 0:
        raise AssertionError(f"spec_identity {cfg.arch}: the oracle leg "
                             "accepted no draft")
    del params
    torch.cuda.empty_cache()
    return row


# ---------------------------------------------------------------------------
# Seeded sampling, crash safety and KV page integrity
# ---------------------------------------------------------------------------

SAMPLING = dict(sampling="top_p", top_p=0.9, temperature=0.8)
DEV = "cuda"                # the new phases' device (a CPU rehearsal sets it)
CRASH_SNAPSHOT_WAVE, CRASH_WAVE = 2, 4   # the crash leg's snapshot, kill
CORRUPT = dict(kv_integrity=True, chaos_corrupt_p=0.3, chaos_seed=5)


def _seeded(reqs, base: int = 1000):
    """Give request i the sampling seed ``base + i``."""
    for i, r in enumerate(reqs):
        r.seed = base + i
    return reqs


def _trace_sampling_chunk(cfg, params, seed: int) -> dict:
    """The sampler's share of a sampled decode chunk: from one state (16
    slots at 512 prompt tokens, as ``phase_trace``) one graphed chunk under
    greedy and one under ``cfg``'s sampling, each timed untraced and then
    traced with torch.profiler (device busy time, idle share, device
    events, the kernels); and the sampler alone at the chunk's logits
    shape, timed by graph replay (time_ms), whole and in its parts:
    ``sample_keys`` (the two threefry folds), ``gumbel`` (threefry over
    every vocabulary counter, the uniform and two logs) and
    ``_mask_logits`` (the top-p sort, softmax and cumsum).  Its share is
    8 steps of it over the sampled chunk's device time.  The keys, random
    bits and uniforms at that shape must equal the CPU's bitwise."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serve import sampling
    from repro_torch.serve.engine import Request, ServeEngine

    rng = np.random.default_rng(seed + 2)
    prompts = [rng.integers(0, cfg.vocab, 512).astype(np.int32)
               for _ in range(SLOTS)]

    def chunk(c, what):
        eng = ServeEngine(c, params, batch_slots=SLOTS, max_len=MAX_LEN,
                          chunk_size=8, device=DEV)
        eng.submit(_seeded([Request(prompt=p, max_new_tokens=25)
                            for p in prompts], 2000))
        eng.step()                  # admission wave + one warm chunk
        t0 = time.perf_counter()
        eng._run_chunk()            # ends in the chunk's device-to-host copy
        wall = time.perf_counter() - t0
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            eng._run_chunk()
            traced = time.perf_counter() - t0
        del eng
        rows = _profile_rows(prof)
        return _trace_line(what, wall, traced, rows) | {
            "device_events": sum(c for _, _, c in rows)}

    greedy = chunk(dataclasses.replace(cfg, sampling="greedy"),
                   "greedy_chunk")
    sampled = chunk(cfg, "sampled_chunk")
    gen = torch.Generator(device=DEV).manual_seed(seed + 3)
    logits = torch.randn((SLOTS, cfg.padded_vocab), generator=gen,
                         device=DEV)
    seeds = torch.arange(SLOTS, dtype=torch.int32, device=DEV) + 2000
    tidx = torch.full((SLOTS,), 40, dtype=torch.int32, device=DEV)
    sampler = sampling.Sampler.from_config(cfg)
    keys = sampling.sample_keys(seeds, tidx)
    # The card's keys, bits and uniforms bitwise equal to the CPU's (which
    # the CPU tests hold bitwise equal to JAX's); the Gumbel noise close.
    bits = sampling.random_bits(keys, cfg.padded_vocab)
    keys_cpu = sampling.sample_keys(seeds.cpu(), tidx.cpu())
    bits_cpu = sampling.random_bits(keys_cpu, cfg.padded_vocab)
    for name, got, want in (
            ("keys", keys, keys_cpu), ("bits", bits, bits_cpu),
            ("uniforms", sampling.uniform(bits), sampling.uniform(bits_cpu))):
        check_equal(f"sampler {name}, card against CPU", got.cpu(), want)
    gumbel_diff = (sampling.gumbel(keys, cfg.padded_vocab).cpu()
                   - sampling.gumbel(keys_cpu, cfg.padded_vocab)).abs().max()
    parts = {
        "sample_keys": time_ms(lambda: sampling.sample_keys(seeds, tidx)),
        "gumbel": time_ms(lambda: sampling.gumbel(keys, cfg.padded_vocab)),
        "mask_logits": time_ms(lambda: sampler._mask_logits(logits)),
    }
    step_ms = time_ms(lambda: sampler(logits, sampling.sample_keys(
        seeds, tidx)))
    busy = sampled["device_busy_ms"]
    return {"chunk": sampled, "chunk_greedy": greedy,
            "device_ms_over_greedy": (
                busy - greedy["device_busy_ms"]
                if busy is not None and greedy["device_busy_ms"] is not None
                else None),
            "sampler_step_ms": step_ms, "sampler_parts_ms": parts,
            "bits_equal_cpu": True,
            "gumbel_max_abs_diff_cpu": gumbel_diff.item(),
            "sampler_share": 8 * step_ms / busy if busy else None}


def phase_serve_sampling(gpu: str, seed: int, cfg, params,
                         cut: str | None = None) -> dict:
    """The serve arm's 48 requests at ``cfg``'s full width with the graph
    on, greedy and then under seeded top-p (0.9 at temperature 0.8, each
    request its own seed) back to back: launch counts checked, one
    replay's kernels held to the capture's, tok/s and ms a chunk of each;
    the first 16 sampled ones with the graph off, streams bitwise equal;
    the trace of a greedy and a sampled chunk from one state and the
    sampler's share of the sampled chunk's device time."""
    from repro_torch.serve.engine import Request

    scfg = dataclasses.replace(cfg, **SAMPLING)
    greqs = _requests(Request, cfg.vocab, seed)
    grun = _serve(cfg, params, greqs)            # greedy, beside it
    check_counts("serve_sampling greedy", grun["counts"], cfg,
                 grun["stats"])
    reqs = _seeded(_requests(Request, cfg.vocab, seed))
    run = _serve(scfg, params, reqs)             # the sampled main path
    stats = run["stats"]
    check_counts("serve_sampling", run["counts"], scfg, stats)
    check_streams("serve_sampling", reqs, scfg)
    ereqs = _seeded(_requests(Request, cfg.vocab, seed))[:SLOTS]
    erun = _serve(scfg, params, ereqs, cuda_graph=False)
    check_counts("serve_sampling eager", erun["counts"], scfg, erun["stats"])
    if [r.generated for r in ereqs] != [r.generated for r in reqs[:SLOTS]]:
        raise AssertionError("serve_sampling: the eager loop's streams "
                             "differ from the graph's")
    trace = _trace_sampling_chunk(scfg, params, seed)
    line = {"phase": "serve_sampling", "gpu": gpu, "arch": cfg.arch,
            "n_layers": cfg.n_layers, "dtype": cfg.dtype, "cut": cut,
            **SAMPLING,
            **_run_line(reqs, run),
            "admission_waves": stats["admission_waves"],
            "greedy": _run_line(greqs, grun),
            "chunk_over_greedy": (statistics.mean(run["chunk_s"])
                                  / statistics.mean(grun["chunk_s"])),
            "tok_per_s_over_greedy": grun["wall"] / run["wall"],
            "streams_equal_greedy": sum(a.generated == b.generated
                                        for a, b in zip(reqs, greqs)),
            "eager": {**_run_line(ereqs, erun), "streams_equal": True},
            "trace": trace}
    emit(line)
    return {"launches": run["counts"]}


def _short_requests(Request, vocab: int, seed: int, n: int):
    """n seeded requests, prompts 32-256 and budgets 16-64 tokens, seed
    5000 + i, each prompt's first token its index (an oracle's key)."""
    rng = np.random.default_rng(seed + 31)
    reqs = [Request(prompt=rng.integers(0, vocab, int(m)).astype(np.int32),
                    max_new_tokens=int(k), seed=5000 + i)
            for i, (m, k) in enumerate(zip(rng.integers(32, 257, n),
                                           rng.integers(16, 65, n)))]
    for i, r in enumerate(reqs):
        r.prompt[0] = i
    return reqs


def phase_sampling_identity(seed: int, base, n_layers: int) -> dict:
    """fp32 at ``base``'s width cut to ``n_layers``, 16 seeded requests,
    every stream bitwise equal across: the same requests submitted in
    reverse (top-p); a 128-page pool that preempts (top-p, invariants
    every wave); the speculative engine (spec_k 4) against the plain one
    under temperature sampling, with an oracle proposer drafting the
    plain streams so drafts are accepted."""
    import repro_torch.serve.engine as engine_mod
    from repro_torch import convert
    from repro_torch.serve.engine import Request

    cfg = dataclasses.replace(base, n_layers=n_layers, dtype="float32")
    gen = torch.Generator(device=DEV).manual_seed(seed + 23)
    params = convert.init(cfg, gen, DEV)
    tag = f"sampling_identity {cfg.arch}"
    row = {"arch": cfg.arch, "n_layers": n_layers, "dtype": "float32",
           "requests": SLOTS}

    def run(c, reqs, **kw):
        out = _serve(c, params, reqs, check_replay=False, **kw)
        check_counts(tag, out["counts"], c, out["stats"])
        return {r.seed: r.generated for r in reqs}, out["stats"]

    top_p = dataclasses.replace(cfg, **SAMPLING)
    want, _ = run(top_p, _short_requests(Request, cfg.vocab, seed, SLOTS))
    got, _ = run(top_p, _short_requests(Request, cfg.vocab, seed,
                                        SLOTS)[::-1])
    row["reversed_equal"] = sum(got[k] == v for k, v in want.items())
    pcfg = dataclasses.replace(top_p, strict_invariants=True)
    got, stats = run(pcfg, _short_requests(Request, cfg.vocab, seed, SLOTS),
                     n_pages=128)
    row["preempted"] = stats["preempted"]
    row["preempted_equal"] = sum(got[k] == v for k, v in want.items())
    temp = dataclasses.replace(cfg, sampling="temperature", temperature=0.8)
    plain_reqs = _short_requests(Request, cfg.vocab, seed, SLOTS)
    plain, _ = run(temp, plain_reqs)
    engine_mod_propose = engine_mod.ngram_propose
    engine_mod.ngram_propose = _oracle_proposer(
        [list(r.prompt) + r.generated for r in plain_reqs], cfg.vocab,
        params["embed"]["tok"].device)
    try:
        scfg = dataclasses.replace(temp, spec_k=SPEC_K, spec_ngram=SPEC_NGRAM)
        got, stats = run(scfg, _short_requests(Request, cfg.vocab, seed,
                                               SLOTS), chunk_size=SPEC_CHUNK)
    finally:
        engine_mod.ngram_propose = engine_mod_propose
    row["spec_equal_plain"] = sum(got[k] == v for k, v in plain.items())
    row["spec_draft_accepted"] = stats["draft_accepted"]
    row["spec_acceptance_rate"] = stats["spec_acceptance_rate"]
    for key in ("reversed_equal", "preempted_equal", "spec_equal_plain"):
        if row[key] != SLOTS:
            raise AssertionError(f"{tag}: {key} {row[key]} of {SLOTS}")
    if row["preempted"] <= 0 or row["spec_draft_accepted"] <= 0:
        raise AssertionError(f"{tag}: no preemption or no accepted draft: "
                             f"{row}")
    del params
    torch.cuda.empty_cache()
    return row


def _crash_and_restore(cfg, params, reqs, tmp: str, n_pages=None) -> dict:
    """Serve ``reqs`` with a journal, snapshot after admission wave
    CRASH_SNAPSHOT_WAVE, kill at CRASH_WAVE (chaos_crash_after_wave),
    then restore a fresh graphed engine from the snapshot and the
    journal's suffix and drain it: every request must end with its full
    budget, no page held, the invariants holding and one replay a chunk.
    Returns the restored engine's results and the snapshot, restore and
    first-step times."""
    from repro_torch.serve.chaos import ChaosCrash
    from repro_torch.serve.engine import ServeEngine

    jpath, spath = f"{tmp}/journal.jsonl", f"{tmp}/snapshot.json"
    kw = dict(batch_slots=SLOTS, max_len=MAX_LEN, chunk_size=8,
              n_pages=n_pages, journal_path=jpath, device=DEV)
    e1 = ServeEngine(dataclasses.replace(
        cfg, chaos_crash_after_wave=CRASH_WAVE), params, **kw)
    e1.submit(reqs)
    while e1.stats["admission_waves"] < CRASH_SNAPSHOT_WAVE:
        e1.step()
    t0 = time.perf_counter()
    info = e1.snapshot(spath)
    snapshot_ms = 1e3 * (time.perf_counter() - t0)
    try:
        e1.drain()
    except ChaosCrash as crash:
        wave = crash.wave
    else:
        raise AssertionError(f"{cfg.arch}: the crash point never fired")
    del e1
    gc.collect()
    torch.cuda.empty_cache()
    e2 = ServeEngine(cfg, params, **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rep = e2.restore(spath)
    torch.cuda.synchronize()
    restore_ms = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    e2.step()                   # ends in the chunk's device-to-host copy
    first_step_ms = 1e3 * (time.perf_counter() - t0)
    e2.drain()
    stats = e2.serve_stats()
    bad = [rid for rid, r in e2._by_id.items()
           if r.status != "finished" or len(r.generated) != r.max_new_tokens]
    held = (e2.n_pages - e2.allocator.free_count()) if e2.paged else 0
    replays = stats["chunks"] if e2.cuda_graph else 0
    if bad or held or stats["graph_replays"] != replays:
        raise AssertionError(f"{cfg.arch} restore: unfinished {bad[:4]}, "
                             f"{held} pages held, {stats['graph_replays']} "
                             f"replays for {stats['chunks']} chunks")
    e2.check_invariants()
    results = e2.results()
    del e2
    torch.cuda.empty_cache()
    return {"results": results, "snapshot_ms": snapshot_ms,
            "restore_ms": restore_ms, "first_step_ms": first_step_ms,
            "crash_wave": wave, "snapshot_requests": info["requests"],
            "in_flight": info["in_flight"], "restored": rep["restored"],
            "replayed_events": rep["replayed_events"]}


def _corrupt_leg(name: str, cfg, params, reqs) -> dict:
    """Serve ``reqs`` with integrity on and seeded page corruption
    (CORRUPT): at least one flip injected, at least as many corrupted
    pages found, each quarantined, the invariants holding after every
    wave and at the end, every request its full budget."""
    kcfg = dataclasses.replace(cfg, **CORRUPT)
    run = _serve(kcfg, params, reqs, check_replay=False)
    stats = run["stats"]
    check_counts(name, run["counts"], kcfg, stats)
    check_streams(name, reqs, kcfg)
    injected, found = stats["injected_corruptions"], stats["corrupted_pages"]
    if not 0 < injected <= found == len(run["quarantined"]):
        raise AssertionError(f"{name}: {injected} flips injected, {found} "
                             f"pages found, {len(run['quarantined'])} "
                             "quarantined")
    if run["held"] != len(run["quarantined"]):
        raise AssertionError(f"{name}: {run['held']} pages out of the free "
                             f"list, {len(run['quarantined'])} quarantined")
    return {"injected_corruptions": injected, "corrupted_pages": found,
            "healed_requests": stats["healed_requests"],
            "quarantined_pages": len(run["quarantined"]),
            "integrity_sweeps": stats["integrity_sweeps"],
            "invariant_checks": stats["invariant_checks"],
            "wall_s": run["wall"]}


def phase_serve_snapshot(gpu: str, seed: int, cfg, params,
                         cut: str | None = None) -> dict:
    """Crash safety and KV page integrity at ``cfg``'s full width: the
    serve arm's 48 requests with kv_integrity off and then on, back to
    back (the on-device sweep timed, streams bitwise equal, no mismatch
    found); the crash leg (journal,
    snapshot after wave 2, kill at wave 4, restore on a fresh graphed
    engine), first tokens and streams equal to the uninterrupted run's
    counted (bf16: a re-prefill replaces decode steps); the
    chaos_corrupt_p leg over the first 16 requests; and at 4 layers in
    fp32, 32 short requests whose restored and corrupted runs must give
    the uninterrupted streams bitwise."""
    import tempfile

    from repro_torch import convert
    from repro_torch.serve.engine import Request

    icfg = dataclasses.replace(cfg, kv_integrity=True)
    sweep_ms = []

    def timed_sweeps(eng):
        sweep = eng._integrity_sweep

        def timed():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            bad = sweep()          # ends in its device-to-host copy
            sweep_ms.append(1e3 * (time.perf_counter() - t0))
            return bad
        eng._integrity_sweep = timed

    oreqs = _requests(Request, cfg.vocab, seed)
    orun = _serve(cfg, params, oreqs)                       # integrity off
    check_counts("serve_snapshot off", orun["counts"], cfg, orun["stats"])
    reqs = _requests(Request, cfg.vocab, seed)
    run = _serve(icfg, params, reqs, prepare=timed_sweeps)  # integrity on
    stats = run["stats"]
    check_counts("serve_snapshot integrity", run["counts"], icfg, stats)
    equal = sum(a.generated == b.generated for a, b in zip(reqs, oreqs))
    if equal != len(reqs) or stats["corrupted_pages"]:
        raise AssertionError(f"serve_snapshot: integrity on changed "
                             f"{len(reqs) - equal} streams, found "
                             f"{stats['corrupted_pages']} corrupt pages")
    line = {"phase": "serve_snapshot", "gpu": gpu, "arch": cfg.arch,
            "n_layers": cfg.n_layers, "dtype": cfg.dtype, "cut": cut,
            "integrity": {**_run_line(reqs, run),
                          "integrity_sweeps": stats["integrity_sweeps"],
                          "sweep_ms": statistics.mean(sweep_ms),
                          "sweep_ms_median": statistics.median(sweep_ms),
                          "sweep_ms_max": max(sweep_ms),
                          "sweep_ms_per_chunk": (sum(sweep_ms)
                                                 / stats["chunks"]),
                          "host_syncs": stats["host_syncs"],
                          "streams_equal_off": equal},
            "integrity_off": _run_line(oreqs, orun),
            "tok_per_s_on_over_off": orun["wall"] / run["wall"]}
    uninterrupted = {r.id: r.generated for r in oreqs}
    with tempfile.TemporaryDirectory() as tmp:
        crash = _crash_and_restore(cfg, params,
                                   _requests(Request, cfg.vocab, seed), tmp)
    got = crash.pop("results")
    line["crash"] = {**crash,
                     "first_tokens_equal": sum(
                         got[k][0] == v[0] for k, v in uninterrupted.items()),
                     "streams_equal": sum(got[k] == v
                                          for k, v in uninterrupted.items()),
                     "requests": len(got)}
    line["corrupt"] = _corrupt_leg(
        "serve_snapshot corrupt", cfg, params,
        _requests(Request, cfg.vocab, seed)[:SLOTS])
    # fp32 at 4 layers: restore and corruption give the streams bitwise.
    fcfg = dataclasses.replace(cfg, n_layers=4, dtype="float32")
    gen = torch.Generator(device=DEV).manual_seed(seed + 29)
    fparams = convert.init(fcfg, gen, DEV)
    n = 2 * SLOTS
    base = _short_requests(Request, fcfg.vocab, seed, n)
    _serve(fcfg, fparams, base, check_replay=False)
    want = {r.id: r.generated for r in base}
    with tempfile.TemporaryDirectory() as tmp:
        fcrash = _crash_and_restore(
            fcfg, fparams, _short_requests(Request, fcfg.vocab, seed, n), tmp)
    creqs = _short_requests(Request, fcfg.vocab, seed, n)
    fcorrupt = _corrupt_leg("serve_snapshot fp32 corrupt", fcfg, fparams,
                            creqs)
    line["fp32"] = {
        "n_layers": 4, "requests": n,
        "restore_streams_equal": sum(fcrash["results"][k] == v
                                     for k, v in want.items()),
        "corrupt_streams_equal": sum(r.generated == want[r.id]
                                     for r in creqs),
        "crash_wave": fcrash["crash_wave"], "restored": fcrash["restored"],
        **{f"corrupt_{k}": v for k, v in fcorrupt.items()}}
    for key in ("restore_streams_equal", "corrupt_streams_equal"):
        if line["fp32"][key] != n:
            raise AssertionError(f"serve_snapshot fp32: {key} "
                                 f"{line['fp32'][key]} of {n}")
    del fparams
    torch.cuda.empty_cache()
    emit(line)
    return {"launches": run["counts"]}


# serve_bench's mixed trace (adaptive_rows) with token and page counts x16.
ADAPT = dict(sys=768, tail=64, new=128, junk=576, junk_new=64, warm=48,
             pool=128, rounds=6, slots=2, max_len=1024)
ADAPT_LEGS = {"static_off": (False, None),
              "static_retain": (True, (1.0, "lru", False)),
              "static_bypass": (True, (1.0, "lru", True)),
              "adaptive": (True, None)}


def adaptive_legs(cfg, params, vocab: int, device=None,
                  check_replay: bool = False) -> dict:
    """The four legs of serve_bench's mixed trace at ADAPT's sizes: rounds
    of one re-arriving system prompt beside one never-repeated junk
    prompt, each round submitted and drained.  ``cfg`` is a paged config;
    the legs add prefix sharing and, but static_off, the adaptive policy
    (pinned for the static stances).  Returns per leg its streams, each
    round's system-prompt TTFT, wall time, stats, adaptive report, the
    pool's free + warm pages after the trace and the kernel counts of its
    run (zeroed after the engine's construction: its warm-up chunk and
    capture are set-up); with ``check_replay``, the graphed adaptive
    leg's replay kernels (check_replay_kernels).  Runs on the CPU too (a
    SMOKE config, ``device="cpu"``), where the counters are the card's:
    they depend only on lengths and budgets."""
    from repro_torch.serve.adaptive import ServeCombo
    from repro_torch.serve.engine import Request, ServeEngine

    legs = {}
    for name, (adapt, pinned) in ADAPT_LEGS.items():
        lcfg = dataclasses.replace(cfg, prefix_sharing=True, adaptive=adapt,
                                   warm_pages=ADAPT["warm"] if adapt else 0,
                                   adaptive_replan_every=1,
                                   strict_invariants=True)
        eng = ServeEngine(lcfg, params, batch_slots=ADAPT["slots"],
                          max_len=ADAPT["max_len"], chunk_size=8,
                          n_pages=ADAPT["pool"], device=device)
        if pinned is not None:
            eng.adaptive.pinned = ServeCombo.from_row(pinned)
        on_card = torch.device(eng.device).type == "cuda"
        if on_card:
            torch.cuda.synchronize()
        reset_counts()
        rng = np.random.default_rng(5)
        sys_p = rng.integers(0, vocab, ADAPT["sys"]).astype(np.int32)
        outs, ttft = [], []
        t0 = time.perf_counter()
        for _ in range(ADAPT["rounds"]):
            junk = Request(prompt=rng.integers(0, vocab, ADAPT["junk"])
                           .astype(np.int32),
                           max_new_tokens=ADAPT["junk_new"])
            sysr = Request(prompt=np.concatenate(
                [sys_p, rng.integers(0, vocab, ADAPT["tail"])
                 .astype(np.int32)]), max_new_tokens=ADAPT["new"])
            eng.submit([junk, sysr])
            eng.drain()
            outs.append((list(junk.generated), list(sysr.generated)))
            ttft.append(sysr.ttft_s)
        if on_card:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = counts()
        eng.check_invariants()
        legs[name] = {"outs": outs, "ttft": ttft, "wall": wall,
                      "stats": eng.serve_stats(),
                      "report": eng.policy_report()["adaptive"],
                      "pool": sorted(eng.allocator.free_pages
                                     + list(eng.allocator.warm_pages)),
                      "counts": got,
                      "replay_kernels": (
                          check_replay_kernels(cfg.arch, eng)
                          if check_replay and name == "adaptive"
                          and eng._graph is not None else None)}
        del eng
    return legs


def check_adaptive_legs(legs: dict) -> dict:
    """serve_bench.adaptive_rows' placement gates: no page leaked in any
    leg; adaptive's prefill work at most the best static leg's and below
    static_off's; at least one re-plan and one warm revive; the novel
    class moved to bypass.  Returns the work per leg."""
    work = {n: leg["stats"]["prefill_work_tokens"] for n, leg in legs.items()}
    for name, leg in legs.items():
        if leg["pool"] != list(range(ADAPT["pool"])):
            raise AssertionError(f"serve_adaptive {name}: pages leaked")
    best_static = min(v for n, v in work.items() if n != "adaptive")
    ad = legs["adaptive"]
    novel = ad["report"]["combos"].get("novel")
    gates = {"work_le_best_static": work["adaptive"] <= best_static,
             "work_lt_static_off": work["adaptive"] < work["static_off"],
             "replans": ad["stats"]["replans"] >= 1,
             "warm_hits": ad["stats"]["warm_hits"] >= 1,
             "novel_bypass": novel is not None and novel[2] is True}
    failed = [g for g, ok in gates.items() if not ok]
    if failed:
        raise AssertionError(f"serve_adaptive: gates {failed} failed: "
                             f"work {work}, combos {ad['report']['combos']}")
    return work


def phase_serve_adaptive(gpu: str, cfg, params,
                         cut: str | None = None) -> dict:
    """The adaptive serve-tier policy at ``cfg``'s full width: the four
    legs of the mixed trace, their placement gates, and per leg (not
    gated) the re-arrival TTFT and wall time; streams equal across legs
    are counted (bf16: a warm revive prefills the tail alone, at other
    shapes than a full prefill).  Each leg's launch counts are checked;
    the line's are their sum, and the adaptive leg's graph replay is
    held to its capture."""
    legs = adaptive_legs(cfg, params, cfg.vocab, check_replay=True)
    for name, leg in legs.items():
        check_counts(f"serve_adaptive {name}", leg["counts"], cfg,
                     leg["stats"])
    if not legs["adaptive"]["replay_kernels"]:
        raise AssertionError("serve_adaptive: the adaptive leg's graph "
                             "replay was not checked")
    launches = {key: sum(leg["counts"][key] for leg in legs.values())
                for key in legs["adaptive"]["counts"]}
    work = check_adaptive_legs(legs)
    ref = legs["static_off"]["outs"]
    keys = ("prefill_work_tokens", "warm_retained", "warm_reclaimed",
            "warm_hits", "warm_tokens_saved", "replans", "admission_waves",
            "chunks", "graph_replays")
    out = {"launches": launches}
    emit({"phase": "serve_adaptive", "gpu": gpu, "arch": cfg.arch,
          "n_layers": cfg.n_layers, "cut": cut, "dtype": cfg.dtype,
          **ADAPT,
          "legs": {n: {**{k: leg["stats"][k] for k in keys},
                       "rearrival_ttft_ms": 1e3 * statistics.mean(
                           leg["ttft"][1:]),
                       "first_ttft_ms": 1e3 * leg["ttft"][0],
                       "wall_s": leg["wall"],
                       "rounds_equal_static_off_share": sum(
                           a == b for a, b in zip(leg["outs"], ref))
                       / len(ref),
                       "combos": leg["report"].get("combos")}
                   for n, leg in legs.items()},
          "best_static_work": min(v for n, v in work.items()
                                  if n != "adaptive"),
          "gates": "held", "launch_counts": launches,
          "replay_kernels": legs["adaptive"]["replay_kernels"]})
    return out


# ---------------------------------------------------------------------------
# Phase 5: kernel path against the plain path, end to end
# ---------------------------------------------------------------------------

def phase_e2e(gpu: str, seed: int, base, want=None,
              compare: str = "pallas_paged vs xla",
              ragged: bool = True, gated: bool = True) -> None:
    """The kernel route (pallas_paged) on ``base``, an fp32 config cut in
    depth, against ``want`` (default: the plain route, xla, of the same
    config): a ragged prefill (``ragged`` False: every row valid), 4
    decode steps with a slot parking every other step, and a continuation
    prefill at nonzero cursors with one slot parked, logits within 2e-3.
    A fixed-source family's caches take the first slots' sources of
    ``_source_extras``, so its encoder (or vision projection) runs on each
    route too.  ``gated`` False (a bf16 ``base``) measures the routes' gap
    (max |got - want| beside max |want|) without a tolerance: rounding to
    bf16 at other places through a model's depth is not a fault of either
    route, and the fp32 run of the same config is the gate.

    Padding rows are garbage by contract, and the two routes' garbage
    differs (the flash kernel writes zeros there, the plain path
    attends).  Under sorted MoE dispatch those rows contend for expert
    capacity, so two routes can drop different real tokens: the sorted
    kernel-vs-plain check prefills without padding (``ragged`` False).
    Its later blocks (4 and 128 tokens) cannot overflow the 128-row
    capacity floor."""
    from repro_torch import convert
    from repro_torch.device import torch_dtype
    from repro_torch.models import build_model

    dt = torch_dtype(base.dtype)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    params = convert.init(base, gen, "cuda")
    b, max_len = 4, 256
    extras = {k: v[:b] for k, v in (_source_extras(base, seed) or {}).items()}
    rng = np.random.default_rng(seed)
    peak = []               # max |want| of each comparison

    def compare_logits(name, got, want_):
        peak.append(want_.float().abs().max().item())
        if gated:
            return check_close(name, got, want_, dt)
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{name}: non-finite kernel output")
        return (got.float() - want_.float()).abs().max().item()

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
            c = m.init_cache(params, batch=b, max_len=max_len, **extras)
            if "pages" in c:
                c["pages"] = torch.arange(
                    c["pages"].numel(), dtype=torch.int32,
                    device="cuda").reshape(c["pages"].shape)
            models[arm], caches[arm] = m, c
        logits = {}
        for arm, m in models.items():
            logits[arm], caches[arm] = m.prefill(params, caches[arm], toks,
                                                   seg_lens=seg)
        errs.append(compare_logits("e2e prefill", logits["got"],
                                   logits["want"]))
        for step in range(4):
            nxt = logits["want"][:, -1].argmax(-1).to(torch.int32)[:, None]
            active = torch.tensor([1, 1, step % 2, 1], dtype=torch.int32,
                                  device="cuda")
            for arm, m in models.items():
                logits[arm], caches[arm] = m.decode_step(
                    params, caches[arm], nxt, seg_lens=active)
            errs.append(compare_logits(f"e2e decode {step}",
                                       logits["got"], logits["want"]))
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
        errs.append(compare_logits("e2e continuation prefill",
                                   logits["got"][live],
                                   logits["want"][live]))
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
          "dtype": base.dtype, "max_abs_err": max(errs),
          "max_abs_logit": max(peak), "tol": 2e-3 if gated else None,
          "gated": gated})


# ---------------------------------------------------------------------------
# The trainer: forward/loss, activation remat, AdamW, checkpoints, the loop
# ---------------------------------------------------------------------------

LN_VOCAB_GATE = 0.5         # step 1's loss within this of ln(vocab)
MIN_FREE_BYTES = 4 << 30    # halve the batch if the peak leaves less free


def _sync() -> None:
    if DEV == "cuda":
        torch.cuda.synchronize()


def _mem_reset() -> None:
    if DEV == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()


def _mem() -> dict:
    """Allocated now, and the peaks since the last ``_mem_reset`` (zeros
    off the card)."""
    if DEV != "cuda":
        return {"allocated": 0, "max_allocated": 0, "max_reserved": 0}
    torch.cuda.synchronize()
    return {"allocated": torch.cuda.memory_allocated(),
            "max_allocated": torch.cuda.max_memory_allocated(),
            "max_reserved": torch.cuda.max_memory_reserved()}


def _total_memory() -> int:
    return (torch.cuda.get_device_properties(0).total_memory
            if DEV == "cuda" else 1 << 40)


def _train_flops(cfg, n_params: int, b: int, s: int) -> float:
    """6 N T for the parameters (a tied head counted once, as it is used
    once as a matmul) plus the plain attention's 12 b s^2 hq dh a layer
    (QK^T and PV, forward and backward), recompute not counted."""
    return (6 * n_params * b * s
            + 12 * b * s * s * cfg.n_heads * cfg.head_dim_ * cfg.n_layers)


def _grads_reached(leaves) -> dict:
    """Every leaf's .grad finite with a nonzero norm (one host sync)."""
    missing = [i for i, p in enumerate(leaves) if p.grad is None]
    if missing:
        raise AssertionError(f"train: {len(missing)} parameter leaves got "
                             f"no .grad (first: leaf {missing[0]})")
    norms = torch.stack([p.grad.float().norm() for p in leaves]).cpu()
    bad = [i for i, n in enumerate(norms.tolist())
           if not (math.isfinite(n) and n > 0)]
    if bad:
        raise AssertionError(f"train: {len(bad)} parameter leaves have a "
                             f"zero or non-finite gradient (first: leaf "
                             f"{bad[0]}, norm {norms[bad[0]].item()})")
    return {"leaves": len(leaves), "min_norm": norms.min().item(),
            "max_norm": norms.max().item()}


def _trace_train_step(train_step, state, batch, wall_ms: float) -> dict:
    """One more train step under torch.profiler: device busy time and idle
    share (against ``wall_ms``, the untraced median), the kernels by device
    time, and the aten operators that launched them (``by_op``: an
    operator's own device time, the backward's included), which says how
    much is the attention's fp32 ``bmm`` and softmax and how much the bf16
    ``mm`` projections."""
    from torch.profiler import ProfilerActivity, profile

    _sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        train_step(state, batch)
        _sync()
        traced = time.perf_counter() - t0
    line = _trace_line("train step", wall_ms / 1e3, traced,
                       _profile_rows(prof))
    ops = sorted(((e.self_device_time_total, e.key, e.count)
                  for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CPU
                  and e.self_device_time_total > 0), reverse=True)
    line["by_op"] = [{"op": k, "ms": us / 1e3, "count": c}
                     for us, k, c in ops[:16]]
    return line


def phase_train_minicpm(gpu: str, seed: int, cfg, batch: int = 4,
                        seq: int = 2048, steps: int = 8,
                        per_layer_save_all: float | None = None) -> dict:
    """minicpm-2b's train step at full width and depth, bf16, SAVE_DOTS,
    MiniCPM's own warmup-stable-decay schedule, on SyntheticLM batches
    ``step % 2``: every loss finite, step 1's within LN_VOCAB_GATE of
    ln(vocab), the last below the first, and after step 1 every parameter
    leaf's gradient finite and nonzero (a gradient cut by a kernel would
    show here).  If the peak leaves under MIN_FREE_BYTES free, the batch is
    halved (``cut``); the sequence is never shortened.  A ninth step is
    traced (``trace``).  ``per_layer_save_all`` (train_remat's measured
    bytes) asks the H100 policy engine which policy it would pick here."""
    from repro_torch.core import make_engine
    from repro_torch.core.remat import RematPolicy
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.train import optimizer as opt
    from repro_torch.train.step import (TrainConfig, init_train_state,
                                        make_train_step)
    from repro_torch.utils import tree

    t_phase = time.perf_counter()
    tcfg = TrainConfig(remat=RematPolicy.SAVE_DOTS, adamw=opt.AdamWConfig(
        schedule="wsd", warmup_steps=2, total_steps=steps))

    def attempt(batch):
        train_step, model = make_train_step(cfg, tcfg, DEV)
        state = init_train_state(
            model, torch.Generator(device=DEV).manual_seed(seed + 41))
        data = SyntheticLM(cfg, batch=batch, seq=seq, seed=seed)
        _mem_reset()
        rows = []
        for i in range(steps):
            t0 = time.perf_counter()
            state, m = train_step(state, data(i % 2))
            rows.append({"step": i + 1, "loss": float(m["loss"]),
                         "ms": (time.perf_counter() - t0) * 1e3,
                         "lr": float(m["lr"]),
                         "grad_norm": float(m["grad_norm"])})
            if i == 0:
                reached = _grads_reached(tree.leaves(state["params"]))
                mem1 = _mem()
                if _total_memory() - mem1["max_reserved"] < MIN_FREE_BYTES:
                    raise torch.cuda.OutOfMemoryError("under 4 GB free")
        return train_step, state, data, rows, reached, mem1

    cut = None
    while True:
        try:
            train_step, state, data, rows, reached, mem1 = attempt(batch)
            break
        except torch.cuda.OutOfMemoryError as e:
            if batch == 1:
                raise
            cut = f"batch {batch} -> {batch // 2} ({e})"[:200]
        gc.collect()            # the failed attempt's state, out of scope
        torch.cuda.empty_cache()
        batch //= 2
    n_params = tree.tree_param_count(state["params"])
    state_bytes = tree.tree_bytes(state)
    mem = _mem()
    step_ms = statistics.median(r["ms"] for r in rows[1:])
    trace = (_trace_train_step(train_step, state, data(steps % 2), step_ms)
             if DEV == "cuda" else None)
    losses = [r["loss"] for r in rows]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"train_minicpm: non-finite loss {losses}")
    if abs(losses[0] - math.log(cfg.vocab)) > LN_VOCAB_GATE:
        raise AssertionError(f"train_minicpm: step 1 loss {losses[0]} not "
                             f"within {LN_VOCAB_GATE} of ln {cfg.vocab}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"train_minicpm: loss did not fall {losses}")
    tokens = batch * seq
    flops = _train_flops(cfg, n_params, batch, seq)
    engine = make_engine(chip="h100")
    pick = None
    if per_layer_save_all:
        free = _total_memory() - state_bytes
        pick = {"activation_bytes_per_layer": per_layer_save_all,
                "n_layers": cfg.n_layers, "hbm_free_bytes": free,
                "policy": engine.remat_policy(per_layer_save_all,
                                              cfg.n_layers, free).value,
                "policy_engine_default_free": engine.remat_policy(
                    per_layer_save_all, cfg.n_layers).value}
    out = {"phase": "train_minicpm", "gpu": gpu, "arch": cfg.arch,
           "n_layers": cfg.n_layers, "d_model": cfg.d_model,
           "dtype": cfg.dtype, "params": n_params,
           "state_bytes": state_bytes, "batch": batch, "seq": seq,
           "cut": cut, "remat": tcfg.remat.value, "schedule": "wsd",
           "steps": rows, "step_ms": step_ms,
           "tokens_per_s": tokens / step_ms * 1e3,
           "flops_per_step": flops,
           "flops": "6 N T + 12 b s^2 hq dh L (plain attention, recompute "
                    "not counted)",
           "model_tflops_per_s": flops / step_ms * 1e-9,
           "max_memory_allocated": mem["max_allocated"],
           "max_memory_reserved": mem["max_reserved"],
           "step1_memory": mem1, "grads_reached": reached,
           "remat_pick": pick, "trace": trace,
           "phase_s": time.perf_counter() - t_phase}
    emit(out)
    return out


def phase_train_remat(gpu: str, seed: int, cfg, cut: str, batch: int = 4,
                      seq: int = 2048, reps: int = 3) -> dict:
    """The three activation policies on one state and batch at ``cfg``'s
    (cut) depth: each one's saved bytes after the forward above the state
    (``saved``), the peak of forward + backward above it (``peak``), the
    same for the model with no layers (``head``: embedding, final norm,
    LM head, loss), so a layer's share is (saved - head) / L; the median
    forward + backward ms of ``reps`` after a warm one.  Measured ratios
    beside choose_policy's modelled 0.45 / 0.06 and extra_flops_factor's
    1.12 / 1.33.  Losses and gradients must agree across the policies
    (bf16 TOL per leaf, relative to the leaf's max |grad|); whether they
    are bitwise equal is printed."""
    from repro_torch.core.remat import RematPolicy, extra_flops_factor
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import build_model
    from repro_torch.train.step import batch_to_device, init_train_state
    from repro_torch.utils import tree

    t_phase = time.perf_counter()
    data = batch_to_device(SyntheticLM(cfg, batch, seq, seed=seed)(0), DEV)
    gen_seed = seed + 47

    def measure(c, policy, keep_grads):
        model = build_model(c, DEV)
        params = init_train_state(
            model, torch.Generator(device=DEV).manual_seed(gen_seed))[
            "params"]
        leaves = tree.leaves(params)
        state_bytes = tree.tree_bytes(params)
        ms = []
        for rep in range(reps + 1):
            _sync()
            base = _mem()["allocated"]
            _mem_reset()
            t0 = time.perf_counter()
            loss, _ = model.loss(params, data, remat=policy)
            saved = _mem()["allocated"] - base
            grads = torch.autograd.grad(loss, leaves)
            _sync()
            ms.append((time.perf_counter() - t0) * 1e3)
            peak = _mem()["max_allocated"] - base
            if rep < reps:
                del grads
        return {"loss": loss.detach(), "grads": grads if keep_grads else None,
                "saved": saved, "peak": peak, "state_bytes": state_bytes,
                "ms": statistics.median(ms[1:])}

    head = measure(dataclasses.replace(cfg, n_layers=0),
                   RematPolicy.SAVE_ALL, False)
    runs = {pol: measure(cfg, pol, True) for pol in RematPolicy}
    base = runs[RematPolicy.SAVE_ALL]
    agree = {}
    for pol, run in runs.items():
        errs = []
        for g, w in zip(run["grads"], base["grads"]):
            scale = w.float().abs().max().item() or 1.0
            err = (g.float() - w.float()).abs().max().item() / scale
            errs.append(err)
        if max(errs) > 2 ** -7 or not math.isfinite(run["loss"].item()):
            raise AssertionError(f"train_remat: {pol.value} gradients off "
                                 f"SAVE_ALL's by {max(errs)} of max |grad|")
        agree[pol.value] = {
            "loss": run["loss"].item(),
            "loss_bitwise": bool(torch.equal(run["loss"], base["loss"])),
            "grads_bitwise": all(torch.equal(g, w) for g, w in
                                 zip(run["grads"], base["grads"])),
            "max_rel_grad_err": max(errs)}
    L = cfg.n_layers
    rows = {}
    for pol, run in runs.items():
        rows[pol.value] = {
            "saved_bytes": run["saved"], "peak_bytes": run["peak"],
            "per_layer_saved_bytes": (run["saved"] - head["saved"]) / L,
            "fwd_bwd_ms": run["ms"]}
    per = {k: r["per_layer_saved_bytes"] for k, r in rows.items()}
    ms = {k: r["fwd_bwd_ms"] for k, r in rows.items()}

    def ratio(a, b):        # no memory counters off the card
        return a / b if b else None
    out = {"phase": "train_remat", "gpu": gpu, "arch": cfg.arch,
           "n_layers": L, "dtype": cfg.dtype, "batch": batch, "seq": seq,
           "cut": cut,
           "state_bytes": base["state_bytes"],
           "head": {"saved_bytes": head["saved"], "peak_bytes": head["peak"],
                    "fwd_bwd_ms": head["ms"]},
           "policies": rows, "agree": agree,
           "saved_ratio": {
               "save_dots": ratio(per["save_dots"], per["save_all"]),
               "recompute": ratio(per["recompute"], per["save_all"]),
               "modelled": {"save_dots": 0.45, "recompute": 0.06}},
           "time_ratio": {
               "save_dots": ratio(ms["save_dots"], ms["save_all"]),
               "recompute": ratio(ms["recompute"], ms["save_all"]),
               "modelled": {
                   "save_dots": extra_flops_factor(RematPolicy.SAVE_DOTS),
                   "recompute": extra_flops_factor(RematPolicy.RECOMPUTE)}},
           "phase_s": time.perf_counter() - t_phase}
    emit(out)
    del runs, base
    return out


def phase_forward_kernels(gpu: str, seed: int, cfg, batch: int = 2,
                          seq: int = 2048, gated: bool = True) -> dict:
    """``forward`` under no_grad on the kernel route (pallas_paged: flash
    causal with no cache, the fused norm) against "xla" from the same
    params and tokens: fp32 (``gated``) within TOL, bf16 the gap beside
    max |logit|.  The kernel run must launch flash once a layer and the
    norm 2 L + 1 times, with no plain call."""
    from repro_torch import convert
    from repro_torch.models import build_model

    t_phase = time.perf_counter()
    dt = torch.float32 if cfg.dtype == "float32" else torch.bfloat16
    gen = torch.Generator(device=DEV).manual_seed(seed + 53)
    params = convert.init(cfg, gen, DEV)
    rng = np.random.default_rng(seed)
    toks = torch.from_numpy(rng.integers(
        0, cfg.vocab, size=(batch, seq)).astype(np.int32)).to(DEV)
    out, ms, launched = {}, {}, None
    with torch.no_grad():
        for kernel in ("xla", "pallas_paged"):
            model = build_model(dataclasses.replace(cfg, decode_kernel=kernel),
                                DEV)
            model.forward(params, toks)          # warm
            _sync()
            reset_counts()
            t0 = time.perf_counter()
            out[kernel], _ = model.forward(params, toks)
            _sync()
            ms[kernel] = (time.perf_counter() - t0) * 1e3
            if kernel == "pallas_paged":
                launched = counts()
    L = cfg.n_layers
    want = {"flash_dense": L, "fused_norm": 2 * L + 1, "plain": 0}
    if DEV == "cuda" and any(launched[k] != v for k, v in want.items()):
        raise AssertionError(f"forward_kernels: launches {launched}, "
                             f"expected {want}")
    got, ref = out["pallas_paged"], out["xla"]
    if not bool(torch.isfinite(got).all()):
        raise AssertionError("forward_kernels: non-finite kernel logits")
    err = (check_close("forward_kernels", got, ref, dt) if gated
           else (got.float() - ref.float()).abs().max().item())
    row = {"phase": "forward_kernels", "gpu": gpu, "arch": cfg.arch,
           "n_layers": L, "dtype": cfg.dtype, "batch": batch, "seq": seq,
           "launches": launched, "expected": want, "max_abs_err": err,
           "max_abs_logit": ref.float().abs().max().item(),
           "tol": list(TOL[dt]) if gated else None, "gated": gated,
           "kernel_ms": ms["pallas_paged"], "xla_ms": ms["xla"],
           "phase_s": time.perf_counter() - t_phase}
    emit(row)
    del out, params
    return row


def phase_train_resume(gpu: str, seed: int, cfg, cut: str, batch: int = 2,
                       seq: int = 2048) -> dict:
    """``loop.run`` at ``cfg``'s (cut) depth: 3 steps and a checkpoint,
    the checkpoint restored into a fresh state (bitwise the saved state),
    3 more from it by auto-resume; separately 6 straight.  The resumed
    run's batches must equal the straight run's bitwise, and its final
    params the straight run's within 4 x lr_max x 3 (three Adam steps of
    at most about lr each, apart) plus one bf16 step of the leaf's max;
    whether they are bitwise equal is printed."""
    import hashlib
    import tempfile

    from repro_torch.core.remat import RematPolicy
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import loop as train_loop
    from repro_torch.train import optimizer as opt
    from repro_torch.train.step import (TrainConfig, init_train_state,
                                        make_train_step)
    from repro_torch.utils import tree

    t_phase = time.perf_counter()
    adamw = opt.AdamWConfig(schedule="wsd", warmup_steps=2, total_steps=6)
    train_step, model = make_train_step(
        cfg, TrainConfig(remat=RematPolicy.SAVE_DOTS, adamw=adamw), DEV)
    data = SyntheticLM(cfg, batch=batch, seq=seq, seed=seed)
    seen = {"straight": {}, "resumed": {}}

    def fresh():
        return init_train_state(
            model, torch.Generator(device=DEV).manual_seed(seed + 59))

    def source(run):
        def batch_of(step):
            b = data(step)
            seen[run][step] = hashlib.sha256(
                b["tokens"].tobytes() + b["labels"].tobytes()).hexdigest()
            return b
        return batch_of

    def loop_cfg(d, total, every):
        return train_loop.LoopConfig(total_steps=total, ckpt_every=every,
                                     ckpt_dir=d, handle_signals=False)

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        straight, rep_s = train_loop.run(
            train_step, fresh(), source("straight"),
            loop_cfg(f"{tmp}/straight", 6, 100))
        straight_s = time.perf_counter() - t0
        straight = ckpt.host_copy(straight["params"])
        gc.collect()
        first, rep1 = train_loop.run(train_step, fresh(), source("resumed"),
                                     loop_cfg(f"{tmp}/run", 3, 3))
        saved = ckpt.host_copy(first)
        del first
        ck_dir = f"{tmp}/run/step_{3:08d}"
        written = sum(os.path.getsize(os.path.join(ck_dir, f))
                      for f in os.listdir(ck_dir))
        t0 = time.perf_counter()
        restored, step = ckpt.restore(f"{tmp}/run", template=fresh())
        _sync()
        restore_ms = (time.perf_counter() - t0) * 1e3
        bad = [tree.path_str(p) for (p, a), (_, b) in zip(
            tree.leaves_with_paths(ckpt.host_copy(restored)),
            tree.leaves_with_paths(saved)) if not torch.equal(a, b)]
        if step != 3 or bad:
            raise AssertionError(f"train_resume: restored state not the "
                                 f"saved one bitwise (step {step}, {bad[:3]})")
        del restored
        gc.collect()
        resumed, rep2 = train_loop.run(train_step, fresh(),
                                       source("resumed"),
                                       loop_cfg(f"{tmp}/run", 6, 3))
        resumed = ckpt.host_copy(resumed["params"])
    if rep2.resumed_from != 3:
        raise AssertionError(f"train_resume: resumed from "
                             f"{rep2.resumed_from}, not 3")
    if seen["straight"] != seen["resumed"]:
        raise AssertionError("train_resume: replayed batches differ")
    lr_max = adamw.lr
    worst, bitwise = 0.0, True
    for (path, a), (_, b) in zip(tree.leaves_with_paths(resumed),
                                 tree.leaves_with_paths(straight)):
        diff = (a.float() - b.float()).abs().max().item()
        bound = 4 * lr_max * 3 + 2 ** -8 * b.float().abs().max().item()
        if diff > bound:
            raise AssertionError(f"train_resume: {tree.path_str(path)} off "
                                 f"the straight run by {diff} > {bound}")
        worst = max(worst, diff)
        bitwise = bitwise and torch.equal(a, b)
    out = {"phase": "train_resume", "gpu": gpu, "arch": cfg.arch,
           "n_layers": cfg.n_layers, "dtype": cfg.dtype, "batch": batch,
           "seq": seq,
           "cut": cut,
           "checkpoint_bytes": written, "restore_ms": restore_ms,
           "straight_s": straight_s,
           "losses_straight": rep_s.losses,
           "losses_resumed": rep1.losses + rep2.losses,
           "restored_bitwise": True, "batches_bitwise": True,
           "final_params_max_abs_diff": worst,
           "final_params_bitwise": bitwise,
           "tol": "4 x lr x 3 + 2^-8 max|p| a leaf",
           "phase_s": time.perf_counter() - t_phase}
    emit(out)
    return out


# ---------------------------------------------------------------------------
# The paper's workload suite, sequence-parallel decode, data-parallel training
# ---------------------------------------------------------------------------

def phase_suite(gpu: str, seed: int) -> dict:
    """The paper's 17 workloads (``workloads.suite``): each one's ops costed
    by the H100 policy engine's model under every static mode (modeled ms
    of each beside adaptive's, the class it assigns beside the paper's)
    and how many of the 17 adaptive matches (within 5 % of the best static
    mode, ``examples/policy_explorer.py``'s check; counted, not gated);
    then every runnable on the card against the same inputs on the CPU,
    fp32 within TOL with TF32 off (DGEMM also in float64, ``x64``)."""
    from repro_torch import hw
    from repro_torch.core.characterize import classify_workload
    from repro_torch.core.cost_model import workload_cost
    from repro_torch.core.policy import StaticMode
    from repro_torch.workloads.suite import build_suite

    t_phase = time.perf_counter()
    static = (StaticMode.UNCACHED, StaticMode.CACHER, StaticMode.CACHERW)
    rows, matches = [], 0
    for name, w in build_suite().items():
        cost = {m: workload_cost(w.ops, mode=m, chip=hw.H100,
                                 launches_per_op=1) for m in StaticMode}
        best = min(static, key=lambda m: cost[m].t_total)
        adaptive = cost[StaticMode.ADAPTIVE].t_total
        match = adaptive <= cost[best].t_total * 1.05
        matches += match
        rows.append({"workload": name,
                     "class": classify_workload(w.ops, chip=hw.H100).value,
                     "paper_class": w.expected.value,
                     "modeled_ms": {m.value: cost[m].t_total * 1e3
                                    for m in StaticMode},
                     "best_static": best.value,
                     "adaptive_over_best": adaptive / cost[best].t_total,
                     "adaptive_matches": bool(match)})
    tf32 = {"matmul": torch.backends.cuda.matmul.allow_tf32,
            "cudnn": torch.backends.cudnn.allow_tf32}
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    runs = []
    try:
        for x64 in (False, True):
            for name, w in build_suite(x64=x64).items():
                if w.runnable is None or (x64 and name != "DGEMM"):
                    continue
                xs = w.runnable.inputs(torch.Generator().manual_seed(seed))
                want = w.runnable.compute(*xs)
                dev = [x.to(DEV) for x in xs]
                got = w.runnable.compute(*dev)
                if got.dtype != want.dtype or got.shape != want.shape:
                    raise AssertionError(f"suite {name}: {got.dtype} "
                                         f"{tuple(got.shape)} on the card")
                err = check_close(f"suite {name}", got.cpu(), want,
                                  torch.float32)
                runs.append({"workload": name, "dtype": str(got.dtype),
                             "shape": list(got.shape), "max_abs_err": err,
                             "ms": time_ms(lambda: w.runnable.compute(*dev))
                             if DEV == "cuda" else None})
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32["matmul"]
        torch.backends.cudnn.allow_tf32 = tf32["cudnn"]
    out = {"phase": "suite", "gpu": gpu, "chip_model": "h100",
           "adaptive_matches": matches, "workloads": len(rows),
           "rows": rows, "runnables": runs,
           "tf32": {"during_gate": False, "before": tf32},
           "tol": list(TOL[torch.float32]),
           "phase_s": time.perf_counter() - t_phase}
    emit(out)
    return out


SP_RANKS = 4
# (case, batch, sequence, lengths; None = every slot full).  long_500k is
# yi-9b's attention at the configs' long_500k shape; the ragged case
# leaves the last shard with no live position in any slot.
SP_CASES = (("long_500k", 1, 524288, None),
            ("ragged_b4", 4, 131072, (98304, 70000, 33000, 5)))
SP_HEADS = (32, 4, 128)            # yi-9b: query heads, KV heads, head dim
SP_TOL = 3e-2                      # bf16, the reference's (tests/test_kernels)
SP_PARTIAL_TOL = 1e-2              # a shard's fp32 (acc, l) vs the plain's
SP_M_TOL = 1e-3                    # a shard's fp32 running max vs the plain's
SP_RAMP = 4.0                      # V's mean rises 0 -> SP_RAMP over the cache


def _sp_inputs(seed: int, case: int, b: int, s: int, lengths, device,
               dtype=torch.bfloat16):
    """q and lengths of a case (the same on every rank), and a function
    giving shard r's K and V: each drawn from its own seeded generator on
    ``device``, so the ranks and the one-rank run build the same cache.

    V's rows are N(0, 1) plus ``SP_RAMP * position / s``: the output is a
    softmax-weighted mean over up to 524288 rows, which for zero-mean rows
    would sit near 0 (a zero output or a dropped shard inside any
    tolerance); with the ramp it is O(1) and says where the mass was."""
    hq, hkv, d = SP_HEADS
    g = torch.Generator(device=device).manual_seed(seed * 1000 + case)
    q = torch.randn((b, hq, d), generator=g, device=device, dtype=dtype)
    lens = torch.tensor(lengths or (s,) * b, dtype=torch.int32,
                        device=device)
    s_local = s // SP_RANKS

    def shard(r):
        gr = torch.Generator(device=device).manual_seed(
            seed * 1000 + case * 16 + r + 1)
        k, v = (torch.randn((b, hkv, s_local, d), generator=gr,
                            device=device, dtype=dtype) for _ in range(2))
        pos = torch.arange(r * s_local, (r + 1) * s_local, device=device)
        v += (SP_RAMP * pos / s).to(dtype)[None, None, :, None]
        return k, v
    return q, lens, shard


def _sp_err(got, want) -> float:
    """The largest over slots of max |got - want| / max |want| within the
    slot (0 where both are 0; an empty shard's m = -1e30 compared
    exactly).  Inf if ``got`` is not finite where ``want`` is."""
    got, want = got.float(), want.float()
    if got.shape != want.shape or bool(
            (torch.isfinite(want) & ~torch.isfinite(got)).any()):
        return math.inf
    err = (got - want).abs().reshape(want.shape[0], -1).amax(dim=1)
    size = want.abs().reshape(want.shape[0], -1).amax(dim=1)
    return max((e / z if z > 0 else (0.0 if e == 0 else math.inf))
               for e, z in zip(err.tolist(), size.tolist()))


def _sp_m_err(got, want) -> float:
    """max |got - want| of two running maxima; -1e30 (no live position)
    must match exactly."""
    dead = want <= -1e29
    if not torch.equal(got <= -1e29, dead):
        return math.inf
    return (got - want).abs().masked_fill(dead, 0).max().item()


def _sp_splits(b: int, ranks: int) -> int:
    """Splits a rank's kernel takes: about 128 blocks a rank (b x KV heads
    x splits), so the four ranks together fill the card's 132 SMs ~4x."""
    return max(1, 128 // (b * SP_HEADS[1])) * (SP_RANKS // ranks)


def _sp_rank(rank: int, world: int, tmp: str, seed: int, device: str,
             cases, reps: int) -> None:
    """One rank of the sp_decode phase (a spawned process): its shard of
    each case's cache, ``sp_decode_attention`` once with the counters
    zeroed (its launches), then the local kernel, the merge and the whole
    timed ``reps`` times in lockstep; the result to ``tmp``."""
    import torch.distributed as dist

    from repro_torch.distributed import collectives
    from repro_torch.distributed import sp_decode as sp
    from repro_torch.kernels.decode_attention import decode_attention as dk

    torch.set_num_threads(2)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/sp.store",
                            rank=rank, world_size=world)
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    out = []
    try:
        for i, (name, b, s, lengths) in enumerate(cases):
            q, lens, shard = _sp_inputs(seed, i, b, s, lengths, device)
            k, v = shard(rank)
            splits = _sp_splits(b, SP_RANKS)
            scale = q.shape[-1] ** -0.5
            sync()
            dist.barrier()
            dk.reset_counters()
            staged0 = dict(collectives.STAGED)
            got = sp.sp_decode_attention(q, k, v, lens, splits=splits)
            sync()
            launches = dk.decode_attention.launches
            plain = dk.decode_attention_plain.calls
            staged = {key: collectives.STAGED[key] - staged0[key]
                      for key in staged0}
            local_len = sp.local_lengths(lens, rank * k.shape[2], k.shape[2])
            # This rank's merged partials, the kernel's and the plain
            # version's on the same shard (launches not counted above).
            bkv = min(512, k.shape[2])
            part = sp.merge_splits(*dk.decode_attention_partials(
                q, k, v, local_len, scale=scale, bkv=bkv, splits=splits))
            part_plain = sp.merge_splits(*dk.decode_attention_partials_plain(
                q, k, v, local_len, scale=scale, bkv=bkv, splits=splits))
            times = {"kernel": [], "merge": [], "whole": []}
            for _ in range(reps):
                dist.barrier()
                sync()
                t0 = time.perf_counter()
                parts = dk.decode_attention_partials(
                    q, k, v, local_len, scale=scale, bkv=bkv, splits=splits)
                sync()
                t1 = time.perf_counter()
                sp.merge_partials(*sp.merge_splits(*parts))
                sync()
                t2 = time.perf_counter()
                dist.barrier()
                sync()
                t3 = time.perf_counter()
                sp.sp_decode_attention(q, k, v, lens, splits=splits)
                sync()
                t4 = time.perf_counter()
                times["kernel"].append((t1 - t0) * 1e3)
                times["merge"].append((t2 - t1) * 1e3)
                times["whole"].append((t4 - t3) * 1e3)
            out.append({"case": name, "out": got.cpu(), "launches": launches,
                        "plain_calls": plain, "splits": splits,
                        "partials": [t.cpu() for t in part],
                        "partials_plain": [t.cpu() for t in part_plain],
                        "staged": staged,
                        **{f"{k_}_ms": statistics.median(t)
                           for k_, t in times.items()}})
            del k, v
        torch.save(out, f"{tmp}/sp_rank{rank}.pt")
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _spawn(fn, world: int, *args) -> None:
    import torch.multiprocessing as mp

    mp.start_processes(fn, args=(world, *args), nprocs=world,
                       start_method="spawn")


def phase_sp_decode(gpu: str, seed: int, cases=SP_CASES,
                    reps: int = 5) -> dict:
    """Sequence-parallel decode (``distributed.sp_decode``) at yi-9b's
    attention width: 4 ranks share the card over gloo (NCCL will not put
    two ranks on one device; the collectives stage their few KB through
    the host), each holding a quarter of the cache's sequence and running
    the split-KV kernel over it (its launches counted, no plain call),
    merged across ranks.  V's rows carry a ramp in position
    (:func:`_sp_inputs`), so the output is O(1).  Each slot held within
    bf16 3e-2 of its largest |output| against the one-rank kernel over the
    whole cache and the plain version, and each rank's merged (acc, m, l)
    against the plain version's partials of its shard; the ranks' local
    kernel, merge and whole ms (host clock, lockstep, the four ranks'
    kernels overlapping on the card) beside the one-rank kernel's device
    ms and the bound (K and V read once).  The kernels were built before the
    ranks were spawned."""
    import tempfile

    from repro_torch.distributed import sp_decode as sp
    from repro_torch.kernels.decode_attention import decode_attention as dk

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        _spawn(_sp_rank, SP_RANKS, tmp, seed, DEV, cases, reps)
        ranks_s = time.perf_counter() - t0
        per_rank = [torch.load(f"{tmp}/sp_rank{r}.pt", weights_only=False)
                    for r in range(SP_RANKS)]
    rows, total = [], 0
    for i, (name, b, s, lengths) in enumerate(cases):
        q, lens, shard = _sp_inputs(seed, i, b, s, lengths, DEV)
        kv = [shard(r) for r in range(SP_RANKS)]
        k = torch.cat([x[0] for x in kv], dim=2)
        v = torch.cat([x[1] for x in kv], dim=2)
        del kv
        splits = _sp_splits(b, 1)
        whole = dk.decode_attention(q, k, v, lens, splits=splits).float().cpu()
        plain = sp.reference(q, k, v, lens).float().cpu()
        res = [rk[i] for rk in per_rank]
        # On the card one launch a rank and no plain call (a CPU rehearsal
        # takes the plain version: the wrapper's CPU branch).
        want_calls = (1, 0) if DEV == "cuda" else (0, 1)
        for r, rr in enumerate(res):
            if (rr["launches"], rr["plain_calls"]) != want_calls:
                raise AssertionError(
                    f"sp_decode {name}: rank {r} launched the kernel "
                    f"{rr['launches']} times, plain version "
                    f"{rr['plain_calls']} times (want {want_calls})")
            for label, want in (("one-rank kernel", whole),
                                ("plain version", plain)):
                err = _sp_err(rr["out"], want)
                if not err <= SP_TOL:
                    raise AssertionError(
                        f"sp_decode {name}: rank {r} vs the {label}: error "
                        f"{err:.3e} of the slot's largest |output|, beyond "
                        f"{SP_TOL}")
            (acc, m, l), (acc_p, m_p, l_p) = (rr["partials"],
                                              rr["partials_plain"])
            perr = max(_sp_err(acc, acc_p), _sp_err(l, l_p))
            merr = _sp_m_err(m, m_p)
            if not (perr <= SP_PARTIAL_TOL and merr <= SP_M_TOL):
                raise AssertionError(
                    f"sp_decode {name}: rank {r}'s partials vs the plain "
                    f"version's on its shard: (acc, l) error {perr:.3e} "
                    f"(limit {SP_PARTIAL_TOL}), m error {merr:.3e} (limit "
                    f"{SP_M_TOL})")
        if any(not torch.equal(rr["out"], res[0]["out"]) for rr in res):
            raise AssertionError(f"sp_decode {name}: ranks disagree")
        kv_bytes = 2 * k.numel() * k.element_size()
        live = [min(n, s) for n in (lengths or (s,) * b)]
        live_bytes = kv_bytes * sum(live) / (b * s)
        one_ms = plain_ms = library_ms = None
        if DEV == "cuda":
            import torch.nn.functional as F

            mask = (torch.arange(s, device=DEV)[None, :]
                    < lens[:, None])[:, None, None, :]
            one_ms = time_ms(lambda: dk.decode_attention_partials(
                q, k, v, lens, splits=splits))
            plain_ms = time_ms(lambda: sp.reference(q, k, v, lens), reps=5)
            library_ms = time_ms(lambda: F.scaled_dot_product_attention(
                q[:, :, None], k, v, attn_mask=mask, enable_gqa=True))
            del mask
        empty = [r for r in range(SP_RANKS)
                 if all(n <= r * (s // SP_RANKS) for n in live)]
        total += sum(rr["launches"] for rr in res)
        rows.append({
            "case": name, "batch": b, "seq": s, "lengths": live,
            "heads": list(SP_HEADS), "dtype": "bfloat16",
            "ranks": SP_RANKS, "splits_a_rank": res[0]["splits"],
            "one_rank_splits": splits, "empty_shards": empty,
            "kv_bytes": kv_bytes, "live_kv_bytes": live_bytes,
            "max_abs_err_vs_one_rank": max(
                (rr["out"].float() - whole).abs().max().item() for rr in res),
            "max_abs_err_vs_plain": max(
                (rr["out"].float() - plain).abs().max().item() for rr in res),
            "max_rel_err_vs_one_rank": max(_sp_err(rr["out"], whole)
                                           for rr in res),
            "max_rel_err_vs_plain": max(_sp_err(rr["out"], plain)
                                        for rr in res),
            "largest_abs_output": plain.abs().max().item(),
            "partials_rel_err": max(
                max(_sp_err(rr["partials"][j], rr["partials_plain"][j])
                    for j in (0, 2)) for rr in res),
            "partials_m_abs_err": max(
                _sp_m_err(rr["partials"][1], rr["partials_plain"][1])
                for rr in res),
            "launches_a_rank": [rr["launches"] for rr in res],
            "local_kernel_ms": [rr["kernel_ms"] for rr in res],
            "merge_ms": [rr["merge_ms"] for rr in res],
            "whole_ms": [rr["whole_ms"] for rr in res],
            "one_rank_kernel_ms": one_ms, "plain_ms": plain_ms,
            "library_ms": library_ms,
            "bound_ms": live_bytes / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes",
            "staged_through_host": res[0]["staged"]})
        del k, v
        torch.cuda.empty_cache() if DEV == "cuda" else None
    out = {"phase": "sp_decode", "gpu": gpu, "backend": "gloo",
           "host_staged": "gloo takes host tensors: every collective copies "
                          "its CUDA tensor to the host and back "
                          "(collectives.all_reduce); the kernel and the "
                          "merge's arithmetic run on the card",
           "timing": "ranks: host clock around synchronised calls, median "
                     "of reps, the 4 ranks' kernels running at once on one "
                     "card; one_rank_kernel_ms (the kernel's partials over "
                     "the whole cache), plain_ms (its plain version with "
                     "the merge) and library_ms (SDPA, enable_gqa, a "
                     "length mask): CUDA graph replay (time_ms)",
           "tol": {"out": f"{SP_TOL} of the slot's largest |output|",
                   "partials": f"acc, l {SP_PARTIAL_TOL} of the slot's "
                               f"largest; m {SP_M_TOL} absolute"},
           "v_ramp": SP_RAMP, "rows": rows, "launches": total,
           "ranks_s": ranks_s, "phase_s": time.perf_counter() - t_phase}
    emit(out)
    return out


DP_RANKS = 2
# The gate's moments after one step, (1 - b1) * the reduced gradient, held
# leaf by leaf within this share of the leaf's largest |mu| of the
# one-process step's: a step on one rank's rows alone is O(1) off.
DP_MU_TOL = 1e-3


def _checksum(t: torch.Tensor) -> list[int]:
    """Two integer sums of a tensor's bit pattern (plain and position
    weighted): equal tensors give equal checksums."""
    bits = t.detach().contiguous().view(
        {2: torch.int16, 4: torch.int32}[t.element_size()]).reshape(-1).long()
    w = torch.arange(bits.numel(), device=t.device) % 65521 + 1
    return [int(bits.sum()), int((bits * w).sum())]


def _dp_rank(rank: int, world: int, tmp: str, seed: int, device: str,
             gate_cfg, measured_cfg, gate_shape, measured_shape,
             steps: int) -> None:
    """One rank of the train_dp phase (a spawned process).  gate: one
    ZeRO-1 step at ``gate_cfg`` (fp32) over the two ranks; rank 0 then
    takes the one-process step on the same global batch and compares
    (loss, parameters, the gathered first moments); a checkpoint written
    by the two ranks is restored by rank 0 alone (one rank's layout) and
    compared bitwise.  measured: ``steps`` ZeRO-1 steps at
    ``measured_cfg`` (bf16) through ``train_step`` (gradients all-reduced
    in fp32), then the same steps with each gradient averaged by
    ``collectives.compressed_all_reduce`` instead (:func:`_int8_steps`)."""
    import torch.distributed as dist

    from repro_torch.core.remat import RematPolicy
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import optimizer as opt
    from repro_torch.train.step import (TrainConfig, init_train_state,
                                        make_train_step, state_shardings)
    from repro_torch.utils import tree

    torch.set_num_threads(4)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/dp.store",
                            rank=rank, world_size=world)
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    mesh = make_local_mesh(world, 1)
    adamw = opt.AdamWConfig(lr=1e-3, warmup_steps=0, total_steps=10)
    res = {}
    try:
        # --- the fp32 gate ---------------------------------------------
        tcfg = TrainConfig(adamw=adamw, zero1=True,
                           remat=RematPolicy.SAVE_DOTS)
        step, model = make_train_step(gate_cfg, tcfg, device, mesh)
        gen = torch.Generator(device=device).manual_seed(seed + 71)
        state = init_train_state(model, gen, mesh, zero1=True)
        shard = state_shardings(gate_cfg, mesh, state, zero1=True)
        batch = SyntheticLM(gate_cfg, batch=gate_shape[0], seq=gate_shape[1],
                            seed=seed)(0)
        state, m = step(state, batch)
        sync()
        res["gate_loss"] = float(m["loss"])
        res["gate_checksums"] = [_checksum(p) for p in
                                 tree.leaves(state["params"])]
        full_mu = sum(p.numel() * 4 for p in tree.leaves(state["params"]))
        res["gate_moment_bytes"] = {
            "rank": sum(t.numel() * 4 for t in tree.leaves(state["opt"]["mu"])),
            "full": full_mu}
        ck_dir = f"{tmp}/dp_ckpt"
        t0 = time.perf_counter()
        ckpt.save(state, ck_dir, step=1, shardings=shard)
        res["ckpt_save_s"] = time.perf_counter() - t0
        gathered = ckpt.gather_state(state, shard)
        if rank == 0:
            # One process, the same global batch and initial parameters.
            one_step, one_model = make_train_step(
                gate_cfg, dataclasses.replace(tcfg, zero1=False), device)
            one = init_train_state(
                one_model, torch.Generator(device=device).manual_seed(
                    seed + 71))
            one, m1 = one_step(one, batch)
            res["one_process_loss"] = float(m1["loss"])
            res["param_max_abs_diff"] = max(
                (a.detach().float() - b.detach().float()).abs().max().item()
                for a, b in zip(tree.leaves(state["params"]),
                                tree.leaves(one["params"])))
            res["param_close"] = all(
                bool(torch.allclose(a.detach().float(), b.detach().float(),
                                    rtol=5e-3, atol=5e-3))
                for a, b in zip(tree.leaves(state["params"]),
                                tree.leaves(one["params"])))
            # mu = (1 - b1) * the reduced gradient: each leaf's error as a
            # share of the leaf's largest |mu|.
            res["mu_rel_err"] = max(
                ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()
                for a, b in zip(tree.leaves(gathered["opt"]["mu"]),
                                tree.leaves(one["opt"]["mu"])))
            del one
            # 2 -> 1: the two ranks' checkpoint in a one-rank layout.
            template = init_train_state(
                one_model, torch.Generator(device=device).manual_seed(0))
            t0 = time.perf_counter()
            restored, at = ckpt.restore(ck_dir, template=template,
                                        in_place=True)
            sync()
            res["ckpt_restore_s"] = time.perf_counter() - t0
            res["elastic_bitwise"] = at == 1 and all(
                torch.equal(a.detach(), b.detach()) for a, b in zip(
                    tree.leaves(restored), tree.leaves(gathered)))
            res["ckpt_bytes"] = sum(
                os.path.getsize(os.path.join(ck_dir, "step_00000001", f))
                for f in os.listdir(os.path.join(ck_dir, "step_00000001")))
            del restored, template
        del state, gathered, step, model
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
        dist.barrier()
        # --- the bf16 measured arms --------------------------------------
        data = SyntheticLM(measured_cfg, batch=measured_shape[0],
                           seq=measured_shape[1], seed=seed)
        tcfg = TrainConfig(adamw=adamw, zero1=True,
                           remat=RematPolicy.SAVE_DOTS)
        for arm in ("fp32_reduce", "int8"):
            step, model = make_train_step(measured_cfg, tcfg, device, mesh)
            state = init_train_state(
                model, torch.Generator(device=device).manual_seed(seed + 73),
                mesh, zero1=True)
            if arm == "int8":
                rows = _int8_steps(model, state, data, steps, tcfg, mesh,
                                   device)
            else:
                rows = []
                for i in range(steps):
                    dist.barrier()
                    sync()
                    t0 = time.perf_counter()
                    state, m = step(state, data(i))
                    loss = float(m["loss"])
                    rows.append({"loss": loss,
                                 "ms": (time.perf_counter() - t0) * 1e3,
                                 "reduce_ms":
                                     step.collective["seconds"] * 1e3,
                                 "payload_bytes":
                                     step.collective["payload_bytes"]})
            res[arm] = {
                "steps": rows,
                "moment_bytes_rank": sum(
                    t.numel() * 4 for k in ("mu", "nu")
                    for t in tree.leaves(state["opt"][k])),
                "moment_bytes_full": 2 * sum(
                    p.numel() * 4 for p in tree.leaves(state["params"])),
                "checksums_first_last": [
                    _checksum(tree.leaves(state["params"])[j])
                    for j in (0, -1)]}
            del state, step, model
            gc.collect()
            if device == "cuda":
                torch.cuda.empty_cache()
        torch.save(res, f"{tmp}/dp_rank{rank}.pt")
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _int8_steps(model, state, data, steps: int, tcfg, mesh, device
                ) -> list[dict]:
    """``steps`` data-parallel ZeRO-1 steps as ``train_step`` takes them,
    but with each gradient averaged over the ranks by
    ``collectives.compressed_all_reduce`` (int8 on the wire, a shared
    scale, the residuals fed back into the next step's gradient and held
    here for this run only).  Each step's loss (the ranks' mean), ms,
    reduce ms and the int8 bytes this rank sent."""
    import torch.distributed as dist

    from repro_torch.distributed import collectives
    from repro_torch.train import optimizer as opt
    from repro_torch.train.step import batch_to_device, state_shardings
    from repro_torch.utils import tree

    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    group, n = mesh.get_group("data"), mesh.size(0)
    rank = mesh.get_local_rank("data")
    params = state["params"]
    leaves = tree.leaves(params)
    moments = state_shardings(model.config, mesh, state,
                              zero1=True)["opt"]["mu"]
    errors = [torch.zeros_like(p, dtype=torch.float32) for p in leaves]
    rows = []
    for i in range(steps):
        dist.barrier()
        sync()
        t0 = time.perf_counter()
        batch = batch_to_device(data(i), device)
        per = next(iter(batch.values())).shape[0] // n
        batch = {k: v[rank * per:(rank + 1) * per] for k, v in batch.items()}
        for p in leaves:
            p.grad = None
        loss, _ = model.loss(params, batch, remat=tcfg.remat)
        loss.backward()
        t1 = time.perf_counter()
        grads = []
        for j, p in enumerate(leaves):
            red, errors[j] = collectives.compressed_all_reduce(
                p.grad, errors[j], group)
            grads.append(red.to(p.grad.dtype))
        sync()
        reduce_s = time.perf_counter() - t1
        opt.apply_updates(params, grads, state["opt"], tcfg.adamw,
                          shardings=moments)
        loss = float(collectives.all_reduce(loss.detach().clone(),
                                            group=group)) / n
        rows.append({"loss": loss, "ms": (time.perf_counter() - t0) * 1e3,
                     "reduce_ms": reduce_s * 1e3,
                     "payload_bytes": sum(p.numel() for p in leaves)})
    return rows


def phase_train_dp(gpu: str, seed: int, gate_cfg, measured_cfg, cut: str,
                   gate_shape=(4, 512), measured_shape=(4, 1024),
                   steps: int = 3) -> dict:
    """Data-parallel ZeRO-1 training (``train.step`` over a ``(data, 1)``
    mesh) at minicpm-2b's full width, 2 ranks sharing the card over gloo
    (the gradients, parameter blocks and checkpoint gathers staged through
    the host).  fp32 gate at ``gate_cfg``'s depth: one step equal to the
    one-process step on the same global batch (loss rtol 1e-4, parameters
    5e-3, the gathered first moments within ``DP_MU_TOL`` of each leaf's
    largest), parameters bitwise across ranks (bit-pattern checksums), each
    rank's moments half the full bytes, and the ranks' checkpoint
    restored in a one-rank layout bitwise.  Measured at ``measured_cfg``'s
    (cut) depth in bf16: ``steps`` steps with the fp32 all-reduce, then
    with the int8 compressed one; step ms, all-reduce ms (host clock,
    staging included) and payload bytes, moment bytes, the loss gap."""
    import tempfile

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        _spawn(_dp_rank, DP_RANKS, tmp, seed, DEV, gate_cfg, measured_cfg,
               gate_shape, measured_shape, steps)
        ranks_s = time.perf_counter() - t0
        res = [torch.load(f"{tmp}/dp_rank{r}.pt", weights_only=False)
               for r in range(DP_RANKS)]
    r0 = res[0]
    gap = abs(r0["gate_loss"] - r0["one_process_loss"])
    if (gap > 1e-4 * abs(r0["one_process_loss"]) or not r0["param_close"]
            or not r0["mu_rel_err"] <= DP_MU_TOL):
        raise AssertionError(
            f"train_dp: the data-parallel step is not the one-process step "
            f"(loss {r0['gate_loss']} vs {r0['one_process_loss']}, params "
            f"max diff {r0['param_max_abs_diff']}, first moments "
            f"{r0['mu_rel_err']:.3e} of a leaf's largest, limit "
            f"{DP_MU_TOL})")
    if any(r["gate_checksums"] != r0["gate_checksums"] for r in res):
        raise AssertionError("train_dp: parameters differ across ranks")
    for arm in ("fp32_reduce", "int8"):
        if any(r[arm]["checksums_first_last"]
               != r0[arm]["checksums_first_last"] for r in res):
            raise AssertionError(f"train_dp {arm}: parameters differ "
                                 f"across ranks")
        losses = [s["loss"] for s in r0[arm]["steps"]]
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"train_dp {arm}: non-finite loss {losses}")
    if not r0["elastic_bitwise"]:
        raise AssertionError("train_dp: the 2-rank checkpoint did not "
                             "restore bitwise at 1 rank")
    mb = r0["gate_moment_bytes"]
    if mb["rank"] * DP_RANKS != mb["full"]:
        raise AssertionError(f"train_dp: a rank holds {mb['rank']} moment "
                             f"bytes of {mb['full']}")

    def arm_line(arm):
        rows = r0[arm]["steps"]
        return {"losses": [s["loss"] for s in rows],
                "step_ms": statistics.median(s["ms"] for s in rows[1:]),
                "reduce_ms": statistics.median(s["reduce_ms"]
                                               for s in rows[1:]),
                "payload_bytes": rows[-1]["payload_bytes"],
                "moment_bytes_rank": r0[arm]["moment_bytes_rank"],
                "moment_bytes_full": r0[arm]["moment_bytes_full"],
                "steps": rows}

    fp32, int8 = arm_line("fp32_reduce"), arm_line("int8")
    out = {"phase": "train_dp", "gpu": gpu, "arch": gate_cfg.arch,
           "ranks": DP_RANKS, "backend": "gloo", "zero1": True,
           "gate": {"n_layers": gate_cfg.n_layers, "dtype": gate_cfg.dtype,
                    "batch": list(gate_shape),
                    "loss": r0["gate_loss"],
                    "one_process_loss": r0["one_process_loss"],
                    "param_max_abs_diff": r0["param_max_abs_diff"],
                    "mu_rel_err": r0["mu_rel_err"],
                    "tol": f"loss rtol 1e-4, params 5e-3, first moments "
                           f"{DP_MU_TOL} of each leaf's largest",
                    "params_bitwise_across_ranks": True,
                    "moment_bytes": mb,
                    "elastic_2_to_1_bitwise": True,
                    "ckpt_bytes": r0["ckpt_bytes"],
                    "ckpt_save_s": r0["ckpt_save_s"],
                    "ckpt_restore_s": r0["ckpt_restore_s"]},
           "measured": {"n_layers": measured_cfg.n_layers,
                        "dtype": measured_cfg.dtype, "cut": cut,
                        "batch": list(measured_shape),
                        "fp32_reduce": fp32, "int8": int8,
                        "int8_payload_share": int8["payload_bytes"]
                        / fp32["payload_bytes"],
                        "loss_gap_after": abs(int8["losses"][-1]
                                              - fp32["losses"][-1])},
           "timing": "host clock; each step starts after a barrier; "
                     "reduce_ms is the gradient collective with its host "
                     "staging",
           "ranks_s": ranks_s, "phase_s": time.perf_counter() - t_phase}
    emit(out)
    return out


TP_RANKS = 4
# tp_forward's gate: rank 0's gathered fp32 logits within this share of the
# one-process kernel-route forward's largest |logit|.
TP_LOGIT_TOL = 2e-3
# train_tp's gates: the loss (relative) and the gathered first moments
# (each leaf's error over its largest |mu|) against the one-process steps.
TP_LOSS_RTOL = 1e-5
TP_MU_TOL = 1e-3


def _tp_tokens(seed: int, vocab: int, shape, device) -> torch.Tensor:
    rng = np.random.default_rng(seed + 89)
    return torch.from_numpy(rng.integers(0, vocab, size=shape).astype(
        np.int32)).to(device)


def _tp_source_shape(cfg, batch: int) -> dict:
    """The forward's source argument and its shape: whisper's frames
    (batch, enc_seq, d), the VLM's vision tokens (batch, n_vis_tokens,
    d); none for the other families."""
    if cfg.family == "encdec":
        return {"frames": (batch, cfg.enc_seq, cfg.d_model)}
    if cfg.cross_attn_every:
        return {"vis": (batch, cfg.n_vis_tokens, cfg.d_model)}
    return {}


def _tp_source(cfg, seed: int, batch: int, device) -> dict:
    """The forward's source (:func:`_tp_source_shape`), fp32 from the
    seed."""
    gen = torch.Generator(device=device).manual_seed(seed + 95)
    return {k: torch.randn(shape, generator=gen, device=device)
            for k, shape in _tp_source_shape(cfg, batch).items()}


def _tp_want(cfg) -> dict:
    """The launches a rank's kernel-route forward of ``cfg`` must make,
    no plain call: flash once an attention (whisper: each encoder layer,
    each decoder layer's self and cross attention; zamba2: each shared
    block call, one every ``shared_attn_every`` layers; mamba2: none;
    else once a layer), the norm once a norm (whisper: 2 an encoder
    layer, 3 a decoder layer and the two final ones; a Mamba-2 layer 1
    and a shared block call 2; else 2 a layer; and the final one), the
    SSD scan once a Mamba-2 layer, three grouped GEMMs an MoE layer
    (``wgmma`` in bf16, ``cuda_cores`` in fp32)."""
    L = cfg.n_layers
    if cfg.family == "encdec":
        flash, norm = cfg.enc_layers + 2 * L, 2 * cfg.enc_layers + 3 * L + 2
    elif cfg.family in ("ssm", "hybrid"):
        flash = L // cfg.shared_attn_every if cfg.family == "hybrid" else 0
        norm = L + 2 * flash + 1
    else:
        flash, norm = L, 2 * L + 1
    ssd = L if cfg.family in ("ssm", "hybrid") else 0
    gmm = 3 * L if cfg.n_experts else 0
    body = "cuda_cores" if cfg.dtype == "float32" else "wgmma"
    return {"flash_dense": flash, "fused_norm": norm, "ssd": ssd,
            "grouped_matmul": gmm, "plain": 0,
            "gmm_bodies": {body: gmm} if gmm else {}}


def _tp_launches() -> dict:
    from repro_torch.kernels.moe_gmm import moe_gmm as gk

    got = counts()
    keys = ("flash_dense", "fused_norm", "ssd", "grouped_matmul", "plain")
    return {**{k: got[k] for k in keys},
            "others": sum(v for k, v in got.items() if k not in keys),
            "gmm_bodies": {k: v for k, v in
                           gk.grouped_matmul.body_launches.items() if v}}


def _tp_fwd_rank(rank: int, world: int, tmp: str, seed: int, device: str,
                 arms) -> None:
    """One rank of tp_forward (a spawned process): for each arm ``(name,
    cfg, shape)``, the model built over a (1, ``world``) mesh draws this
    rank's blocks, runs one warm forward, then a counted and timed one
    with the collectives clocked (every kernel counter,
    ``collectives.STAGED`` and the clock zeroed just before it, read just
    after).  Rank 0 keeps the gathered logits for the parent."""
    import torch.distributed as dist

    from repro_torch.distributed import collectives, tensor_parallel
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import build_model

    torch.set_num_threads(2)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/tpf.store",
                            rank=rank, world_size=world)
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    mesh = make_local_mesh(1, world)
    res = {}
    try:
        for name, cfg, shape in arms:
            if device == "cuda":
                torch.cuda.reset_peak_memory_stats()
            model = build_model(cfg, device, mesh)
            params = model.init(torch.Generator(device=device).manual_seed(
                seed + 91))
            toks = _tp_tokens(seed, cfg.vocab, shape, device)
            src = _tp_source(cfg, seed, shape[0], device)
            with torch.no_grad():
                model.forward(params, toks, **src)
                sync()
                dist.barrier()
                reset_counts()
                collectives.STAGED.update(collectives=0, bytes=0)
                tensor_parallel.CLOCK.update(on=True, seconds=0.0)
                t0 = time.perf_counter()
                logits, _ = model.forward(params, toks, **src)
                sync()
                ms = (time.perf_counter() - t0) * 1e3
                tensor_parallel.CLOCK.update(on=False)
                launches = _tp_launches()
                staged = dict(collectives.STAGED)
            row = {"forward_ms": ms, "launches": launches,
                   "collective_ms": tensor_parallel.CLOCK["seconds"] * 1e3,
                   "staged_collectives": staged["collectives"],
                   "staged_bytes": staged["bytes"],
                   "param_bytes": sum(p.numel() * p.element_size()
                                      for p in _leaves(params)),
                   "max_memory_allocated": (
                       torch.cuda.max_memory_allocated()
                       if device == "cuda" else 0),
                   "logits_checksum": _checksum(logits)}
            if rank == 0:
                torch.save(logits.cpu(), f"{tmp}/tpf_{name}.pt")
            res[name] = row
            del params, model, logits, src
            gc.collect()
            if device == "cuda":
                torch.cuda.empty_cache()
            dist.barrier()
        torch.save(res, f"{tmp}/tpf_rank{rank}.pt")
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _leaves(params) -> list:
    from repro_torch.utils import tree

    return tree.leaves(params)


def _tp_heads(cfg, world: int) -> tuple[int, int] | None:
    """(query heads, KV heads) one rank's attention runs over: its block
    where the rule splits heads, every head where it splits ``dh`` (q, k,
    v are gathered over ``dh``), and under replicated K/V the KV heads its
    query heads read; None for a model without attention (mamba2)."""
    from repro_torch.distributed import sharding as sh

    if not cfg.n_heads:
        return None

    qh, _ = sh._attn_dims(cfg, cfg.n_heads, world)
    kh, _ = sh._kv_dims(cfg, world)
    hq = cfg.n_heads // world if qh else cfg.n_heads
    if kh:
        return hq, cfg.n_kv_heads // world
    if qh:
        return hq, max(1, hq * cfg.n_kv_heads // cfg.n_heads)
    return hq, cfg.n_kv_heads


def _tp_ssm(cfg, world: int) -> tuple[int, int] | None:
    """(SSM heads, B/C groups) one rank's scan runs over: its block of
    the heads and the groups they read where the heads divide, else every
    head and group; None for a model without Mamba-2 layers."""
    if not cfg.ssm_state:
        return None
    h, g = cfg.ssm_heads, cfg.ssm_groups
    if h % world:
        return h, g
    hl = h // world
    return hl, max(1, hl * g // h)


def _tp_ssd_case(gen, dtype, cfg, b, l, world: int):
    """The scan's inputs at rank 0's split shapes, as the split model
    makes them: x, B and C strided views of the whole gathered conv output
    (rows of ``d_inner + 2 g ds`` channels, this rank's heads and the
    groups they read), dt softplus'ed, A and D on this rank's heads."""
    h, dh, g, ds, di = (cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_groups,
                        cfg.ssm_state, cfg.d_inner)
    hl, gl = _tp_ssm(cfg, world)
    xbc = torch.randn(b, l, di + 2 * g * ds, generator=gen,
                      device=DEV).to(dtype)
    x = xbc[..., :di].reshape(b, l, h, dh)[:, :, :hl]
    B = xbc[..., di:di + g * ds].reshape(b, l, g, ds)[:, :, :gl]
    C = xbc[..., di + g * ds:].reshape(b, l, g, ds)[:, :, :gl]
    dt = torch.nn.functional.softplus(
        torch.randn(b, l, hl, generator=gen, device=DEV) - 1.0)
    A = -torch.linspace(1.0, 16.0, h, device=DEV)[:hl].contiguous()
    D = torch.randn(hl, generator=gen, device=DEV)
    return x, dt, A, B, C, D


def _tp_local_kernels(cfg, shape, world: int, seed: int) -> list[dict]:
    """The kernels of ``cfg``'s split forward at one rank's shapes, against
    their plain versions (TOL), in bf16 and fp32: flash over the rank's
    query and KV heads (causal over the block; whisper's encoder without
    the mask; the cross layers without the mask over the source), the
    fused norm at d_model (LayerNorm with its bias for whisper, over the
    encoder's rows), the grouped GEMM over an MoE rank's experts and every
    token (dense dispatch: x (e/ranks, b s, d) @ wg (e/ranks, d, d_ff)),
    the SSD scan over a rank's heads (:func:`_tp_ssd_case`; its output and
    final state checked, its body recorded, the bf16 one timed beside the
    plain version and the bound, and held to the ``mma`` body where the
    views are aligned)."""
    from repro_torch.kernels.flash_attention import flash_attention as fk
    from repro_torch.kernels.fused_norm import fused_norm as nk
    from repro_torch.kernels.moe_gmm import moe_gmm as gk
    from repro_torch.kernels.ssd import ssd as sk

    b, s = shape
    heads = _tp_heads(cfg, world)
    dh, d = cfg.head_dim_, cfg.d_model
    src = (cfg.enc_seq if cfg.family == "encdec" else
           cfg.n_vis_tokens if cfg.cross_attn_every else None)
    gen = torch.Generator(device=DEV).manual_seed(seed + 93)
    rows = []
    for dt in (torch.bfloat16, torch.float32):
        def randn(*size, scale=1.0):
            return (torch.randn(size, generator=gen, device=DEV) * scale
                    ).to(dt)

        def attn(sq, skv):
            hq, hkv = heads
            return (randn(b, hq, sq, dh), randn(b, hkv, skv, dh),
                    randn(b, hkv, skv, dh))

        cases = [] if heads is None else [
            ("flash_attention", "causal", fk.flash_attention,
             fk.flash_attention_plain, attn(s, s), {"causal": True})]
        if cfg.family == "encdec":
            cases.append(("flash_attention", "encoder", fk.flash_attention,
                          fk.flash_attention_plain, attn(src, src),
                          {"causal": False}))
        if src is not None:
            cases.append(("flash_attention", "source", fk.flash_attention,
                          fk.flash_attention_plain, attn(s, src),
                          {"causal": False}))
        rows_n = src if cfg.family == "encdec" else s
        x = randn(b, rows_n, d)
        w = torch.ones(d, device=DEV) + randn(d, scale=0.1).float()
        norm_args = (x, w) + ((randn(d, scale=0.1).float(),)
                              if cfg.norm_kind == "layer" else ())
        cases.append(("fused_norm", cfg.norm_kind, nk.fused_norm,
                      nk.fused_norm_plain, norm_args,
                      {"eps": cfg.norm_eps, "kind": cfg.norm_kind}))
        if cfg.n_experts:
            e, f = cfg.n_experts // world, cfg.d_ff
            cases.append(("grouped_matmul", "dense dispatch",
                          gk.grouped_matmul, gk.grouped_matmul_plain,
                          (randn(e, b * s, d), randn(e, d, f, scale=d ** -0.5)),
                          {}))
        for name, case, kern, plain, args, kw in cases:
            got, want = kern(*args, **kw), plain(*args, **kw)
            rows.append({"kernel": name, "case": case,
                         "dtype": str(dt).split(".")[-1],
                         "shape": [list(a.shape) for a in args],
                         "max_abs_err": check_close(
                             f"tp_forward local {name} ({case})", got, want,
                             dt)})
            del got, want
        del cases, x, norm_args
        if cfg.ssm_state:
            rows.append(_tp_ssd_row(cfg, gen, dt, b, s, world, sk))
    return rows


def _tp_ssd_row(cfg, gen, dtype, b, l, world: int, sk) -> dict:
    """The SSD scan at a rank's shapes against its plain version (y and
    the final state, TOL); on the card its body and, in bf16, its time,
    the plain version's and the bound (no PyTorch call computes the
    scan)."""
    args = _tp_ssd_case(gen, dtype, cfg, b, l, world)
    chunk = min(max(128, l // 16), 1024)
    (y, S), (yp, Sp) = sk.ssd(*args), sk.ssd_plain(*args, chunk=chunk)
    tag = f"tp_forward local ssd {str(dtype).split('.')[-1]}"
    hl, gl = _tp_ssm(cfg, world)
    row = {"kernel": "ssd", "case": "heads a rank",
           "dtype": str(dtype).split(".")[-1],
           "shape": [b, l, hl, cfg.ssm_headdim, gl, cfg.ssm_state],
           "max_abs_err": max(check_close(tag + " y", y, yp, dtype),
                              check_close(tag + " state", S, Sp,
                                          torch.float32))}
    if DEV == "cuda":
        launch = sk.launch_of(*args)
        row["body"] = launch.body
        if dtype == torch.bfloat16:
            if sk._aligned(args[0], args[3], args[4]) and launch.body != "mma":
                raise AssertionError(f"{tag}: aligned views planned on the "
                                     f"{launch.body} body, not mma")
            bound_ms, bound_by, _ = _ssd_bound(dtype, b, l, *row["shape"][2:],
                                               init_state=False)
            row |= {"ms": time_ms(lambda: sk.ssd_cuda(*args)),
                    "plain_ms": time_ms(lambda: sk.ssd_plain(
                        *args, chunk=chunk), reps=5),
                    "bound_ms": bound_ms, "bound_by": bound_by,
                    "library_ms": None}
            row["over_bound"] = row["ms"] / bound_ms
    return row


def phase_tp_forward(gpu: str, seed: int, models) -> dict:
    """Tensor and expert parallel forwards (``build_model(cfg, device,
    mesh)`` over a (1, 4) mesh) on the kernel route, every model's arms in
    one spawn of 4 ranks that share the card over gloo, each rank holding
    its block of every leaf and running flash, the fused norm, (MoE) the
    grouped GEMM and (Mamba-2) the SSD scan at its local shapes, the
    activations' partial sums
    all-reduced and the split outputs gathered through the host.

    ``models``: dicts with ``phase`` (the line's name), ``gate`` and
    ``measured`` (configs), ``shape`` (tokens), ``cut`` (a string an arm,
    or None).  First each model's kernels at a rank's shapes against their
    plain versions; then each arm's one-process forward in this process
    (its weights freed before the ranks start, only its logits kept); then
    the ranks.  fp32 (``gate``): rank 0's gathered logits within
    ``TP_LOGIT_TOL`` of the largest |logit| of the one-process forward.
    bf16 (``measured``): the gap beside it, ungated.  Each rank's launches
    are held to :func:`_tp_want`; every rank's logits are equal (checksums
    of their bits).  One line a model."""
    import tempfile

    from repro_torch.models import build_model

    t_phase = time.perf_counter()
    local = {m["phase"]: _tp_local_kernels(m["gate"], m["shape"], TP_RANKS,
                                           seed) for m in models}
    arms = [(f"{m['phase']}.{arm}", m[arm], m["shape"]) for m in models
            for arm in ("gate", "measured")]
    one = {}
    for name, cfg, shape in arms:
        model = build_model(cfg, DEV)
        params = model.init(torch.Generator(device=DEV).manual_seed(
            seed + 91))
        toks = _tp_tokens(seed, cfg.vocab, shape, DEV)
        src = _tp_source(cfg, seed, shape[0], DEV)
        with torch.no_grad():
            model.forward(params, toks, **src)
            _sync()
            t0 = time.perf_counter()
            logits, _ = model.forward(params, toks, **src)
            _sync()
        one[name] = {"ms": (time.perf_counter() - t0) * 1e3,
                     "logits": logits.float().cpu()}
        del model, params, logits, src
        gc.collect()
        if DEV == "cuda":
            torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        _spawn(_tp_fwd_rank, TP_RANKS, tmp, seed, DEV, arms)
        ranks_s = time.perf_counter() - t0
        res = [torch.load(f"{tmp}/tpf_rank{r}.pt", weights_only=False)
               for r in range(TP_RANKS)]
        got = {name: torch.load(f"{tmp}/tpf_{name}.pt", weights_only=False)
               for name, _, _ in arms}
    launches = {}
    lines = []
    for m in models:
        gate = m["gate"]
        out = {"phase": m["phase"], "gpu": gpu, "arch": gate.arch,
               "family": gate.family, "ranks": TP_RANKS,
               "mesh": [1, TP_RANKS], "backend": "gloo",
               "route": gate.decode_kernel, "batch": list(m["shape"]),
               "source": _tp_source_shape(gate, m["shape"][0]) or None,
               "heads_a_rank": _tp_heads(gate, TP_RANKS),
               "ssm_heads_groups_a_rank": _tp_ssm(gate, TP_RANKS),
               "local_kernels": local[m["phase"]], "ranks_s": ranks_s}
        if gate.n_experts:
            out["moe_dispatch"] = gate.moe_dispatch
        for arm in ("gate", "measured"):
            cfg, name = m[arm], f"{m['phase']}.{arm}"
            want = _tp_want(cfg)
            rows = [r[name] for r in res]
            for r, row in enumerate(rows):
                got_l = {k: row["launches"][k] for k in want}
                if DEV == "cuda" and (got_l != want
                                      or row["launches"]["others"]):
                    raise AssertionError(
                        f"{name}: rank {r} launches {row['launches']}, "
                        f"expected {want}")
            if any(row["logits_checksum"] != rows[0]["logits_checksum"]
                   for row in rows):
                raise AssertionError(f"{name}: ranks' logits differ")
            split, ref = got[name].float(), one[name]["logits"]
            if not bool(torch.isfinite(split).all()):
                raise AssertionError(f"{name}: non-finite logits")
            gap = (split - ref).abs().max().item()
            scale = ref.abs().max().item()
            if arm == "gate" and not gap <= TP_LOGIT_TOL * scale:
                raise AssertionError(
                    f"{name}: the split forward is {gap:.3e} from the "
                    f"one-process forward, beyond {TP_LOGIT_TOL} of its "
                    f"largest |logit| {scale:.3e}")
            for k in ("flash_dense", "fused_norm", "ssd", "grouped_matmul"):
                launches[k] = launches.get(k, 0) + sum(
                    row["launches"][k] for row in rows)
            out[arm] = {
                "n_layers": cfg.n_layers, "dtype": cfg.dtype,
                "gated": arm == "gate",
                "tol": (f"{TP_LOGIT_TOL} of the largest |logit|"
                        if arm == "gate" else None),
                "max_abs_err": gap, "max_abs_logit": scale,
                "rel_err": gap / scale,
                # Positions whose top logit is the one-process forward's:
                # bf16 partial sums can flip a near-tied MoE routing choice.
                "argmax_agreement": (split.argmax(-1) == ref.argmax(-1)
                                     ).float().mean().item(),
                "forward_ms": [row["forward_ms"] for row in rows],
                "one_process_ms": one[name]["ms"],
                "collective_ms": [row["collective_ms"] for row in rows],
                "staged_collectives": [row["staged_collectives"]
                                       for row in rows],
                "staged_bytes": [row["staged_bytes"] for row in rows],
                "param_bytes": [row["param_bytes"] for row in rows],
                "max_memory_allocated": [row["max_memory_allocated"]
                                         for row in rows],
                "launches": [row["launches"] for row in rows],
                "expected": want, "cut": m["cut"][arm]}
        out["timing"] = (
            "host clock around a synchronised forward with the collectives "
            "clocked (tensor_parallel.CLOCK: a device sync before and after "
            "each, the host staging included), after a warm forward; the "
            "ranks' forwards run at once on one card; one_process_ms: the "
            "same forward in one process; ranks_s and phase_s: the one "
            "spawn and the whole phase, shared by the tp_forward lines")
        lines.append(out)
    phase_s = time.perf_counter() - t_phase
    for out in lines:
        out["phase_s"] = phase_s
        emit(out)
    return {"lines": lines, "total_launches": launches}


def _tp_train_rank(rank: int, world: int, tmp: str, seed: int, device: str,
                   arms, steps: int) -> None:
    """One rank of train_tp (a spawned process), for each arm (a dict:
    ``phase``, ``cfg``, ``shape``, ``ckpt``, ``witness``): ``steps``
    ZeRO-1 steps over a (1, ``world``) mesh with the collectives clocked,
    then the first moments gathered (a collective), or with ``ckpt`` the
    whole state, written by rank 0 as a checkpoint; rank 0 then takes the
    one-process steps on the same batches and compares (loss, the
    gathered first moments, with ``ckpt`` the parameters) and, with
    ``ckpt``, restores the checkpoint in a one-rank layout (bitwise the
    gathered state).  With ``witness`` the parameters and first moments
    are also gathered after the first step, and rank 0 takes two more
    one-process runs (:func:`_tp_witness`)."""
    import torch.distributed as dist

    from repro_torch.core.remat import RematPolicy
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.distributed import collectives, tensor_parallel
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import optimizer as opt
    from repro_torch.train.step import (TrainConfig, init_train_state,
                                        make_train_step, state_shardings)
    from repro_torch.utils import tree

    torch.set_num_threads(2)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/tpt.store",
                            rank=rank, world_size=world)
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    mesh = make_local_mesh(1, world)
    tcfg = TrainConfig(adamw=opt.AdamWConfig(lr=1e-3, warmup_steps=0,
                                             total_steps=10),
                       zero1=True, remat=RematPolicy.SAVE_DOTS)
    out = {}
    try:
        for arm in arms:
            cfg, name = arm["cfg"], arm["phase"]
            data = SyntheticLM(cfg, batch=arm["shape"][0],
                               seq=arm["shape"][1], seed=seed)
            res = out[name] = {}
            if device == "cuda":
                torch.cuda.reset_peak_memory_stats()
            step, model = make_train_step(cfg, tcfg, device, mesh)
            state = init_train_state(
                model, torch.Generator(device=device).manual_seed(seed + 97),
                mesh, zero1=True)
            shard = state_shardings(cfg, mesh, zero1=True)
            rows = []
            for i in range(steps):
                dist.barrier()
                sync()
                collectives.STAGED.update(collectives=0, bytes=0)
                tensor_parallel.CLOCK.update(on=True, seconds=0.0)
                t0 = time.perf_counter()
                state, m = step(state, data(i))
                loss = float(m["loss"])
                ms = (time.perf_counter() - t0) * 1e3
                tensor_parallel.CLOCK.update(on=False)
                rows.append({"loss": loss,
                             "grad_norm": float(m["grad_norm"]), "ms": ms,
                             "collective_ms":
                                 tensor_parallel.CLOCK["seconds"] * 1e3,
                             "staged_collectives":
                                 collectives.STAGED["collectives"],
                             "staged_bytes": collectives.STAGED["bytes"]})
                if i == 0 and arm.get("witness"):
                    # Copies: a replicated leaf is gathered as the live
                    # tensor, which the next step updates in place.
                    first = {"params": [t.clone() for t in tree.leaves(
                        ckpt.gather_state(state["params"], shard["params"]))],
                             "mu": [t.clone() for t in tree.leaves(
                                 ckpt.gather_state(state["opt"]["mu"],
                                                   shard["opt"]["mu"]))]}
                    if rank:
                        del first
            res["steps"] = rows
            res["state_bytes"] = sum(t.numel() * t.element_size()
                                     for t in tree.leaves(state))
            res["max_memory_allocated"] = (
                torch.cuda.max_memory_allocated() if device == "cuda" else 0)
            t0 = time.perf_counter()
            full = (ckpt.gather_state(state, shard) if arm["ckpt"] else
                    {"opt": {"mu": ckpt.gather_state(
                        state["opt"]["mu"], shard["opt"]["mu"])}})
            sync()
            res["gather_s"] = time.perf_counter() - t0
            del state, step, model
            if rank:
                del full
            gc.collect()
            if device == "cuda":
                torch.cuda.empty_cache()
            ck_dir = f"{tmp}/tp_ckpt_{name}"
            if rank == 0:
                if arm["ckpt"]:
                    t0 = time.perf_counter()
                    ckpt.save(full, ck_dir, step=steps)
                    res["ckpt_save_s"] = time.perf_counter() - t0
                    at_dir = os.path.join(ck_dir, f"step_{steps:08d}")
                    res["ckpt_bytes"] = sum(
                        os.path.getsize(os.path.join(at_dir, f))
                        for f in os.listdir(at_dir))
                # One process, the same batches and initial parameters.
                one_step, one_model = make_train_step(
                    cfg, dataclasses.replace(tcfg, zero1=False), device)
                one = init_train_state(
                    one_model, torch.Generator(device=device).manual_seed(
                        seed + 97))
                paths = [tree.path_str(p) for p, _ in
                         tree.leaves_with_paths(full["opt"]["mu"])]
                one_rows, one_first = [], None
                for i in range(steps):
                    sync()
                    t0 = time.perf_counter()
                    one, m1 = one_step(one, data(i))
                    one_rows.append({"loss": float(m1["loss"]),
                                     "grad_norm": float(m1["grad_norm"]),
                                     "ms": (time.perf_counter() - t0) * 1e3})
                    if i == 0 and arm.get("witness"):
                        one_first = _tp_snapshot(one)
                res["one_process"] = one_rows
                errs = _tp_mu_errs(paths, tree.leaves(full["opt"]["mu"]),
                                   tree.leaves(one["opt"]["mu"]))
                res["mu_worst_leaf"] = max(errs, key=errs.get)
                res["mu_rel_err"] = errs[res["mu_worst_leaf"]]
                if arm["ckpt"]:
                    res["param_max_abs_diff"] = max(
                        (a.float() - b.detach().float()).abs().max().item()
                        for a, b in zip(tree.leaves(full["params"]),
                                        tree.leaves(one["params"])))
                if arm.get("witness"):
                    res["witness"] = _tp_witness(
                        paths, first, tree.leaves(full["opt"]["mu"]),
                        one_first, tree.leaves(one["opt"]["mu"]), rows,
                        one_step, one_model, data, tcfg.adamw.lr, seed,
                        device, steps)
                    del first, one_first
                del one, one_step
                gc.collect()
                if device == "cuda":
                    torch.cuda.empty_cache()
                if arm["ckpt"]:
                    template = init_train_state(
                        one_model,
                        torch.Generator(device=device).manual_seed(0))
                    t0 = time.perf_counter()
                    restored, at = ckpt.restore(ck_dir, template=template,
                                                in_place=True)
                    sync()
                    res["ckpt_restore_s"] = time.perf_counter() - t0
                    res["restore_bitwise"] = at == steps and all(
                        torch.equal(a.detach(), b) for a, b in zip(
                            tree.leaves(restored), tree.leaves(full)))
                    del restored, template
                del full, one_model
                gc.collect()
                if device == "cuda":
                    torch.cuda.empty_cache()
            dist.barrier()
        torch.save(out, f"{tmp}/tpt_rank{rank}.pt")
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _tp_snapshot(state) -> dict:
    """Copies of a one-process train state's leaves: params, mu, nu and
    the step count."""
    from repro_torch.utils import tree

    return {"params": [t.detach().clone()
                       for t in tree.leaves(state["params"])],
            "mu": [t.clone() for t in tree.leaves(state["opt"]["mu"])],
            "nu": [t.clone() for t in tree.leaves(state["opt"]["nu"])],
            "count": state["opt"]["count"].clone()}


def _tp_mu_errs(paths, got, want) -> dict:
    """Each leaf's largest gap over ``want``'s largest |mu|, by path."""
    return {path: ((a - b).abs().max()
                   / b.abs().max().clamp_min(1e-30)).item()
            for path, a, b in zip(paths, got, want)}


def _tp_worst(errs: dict) -> dict:
    leaf = max(errs, key=errs.get)
    return {"rel_err": errs[leaf], "leaf": leaf}


def _tp_moved(paths, got, want, lr: float) -> dict:
    """The entries whose parameter after the first step differs by more
    than ``lr`` / 2 (Adam's first update is about ``lr`` times the sign of
    the gradient, so such an entry took the other sign): the total and
    the leaf with the most."""
    counts = {path: int(((a - b).abs() > lr / 2).sum())
              for path, a, b in zip(paths, got, want)}
    leaf = max(counts, key=counts.get)
    return {"entries": sum(counts.values()), "leaf": leaf,
            "in_leaf": counts[leaf]}


def _tp_witness(paths, split_first, split_mu, one_first, one_mu, split_rows,
                one_step, one_model, data, lr: float, seed: int, device: str,
                steps: int) -> dict:
    """Where the split's moments after ``steps`` steps part from the
    one-process steps', and why (rank 0, after both ran).

    * ``first_step``: the split's first moments after step 1 against the
      one-process steps' (gated): the gradient of the same parameters.
    * ``same_params``: the one-process second step from the split's
      parameters and first moments after step 1 (and the one process's
      second moments and count): its first moments against the split's
      after step 2.  Both then take the gradient of the same parameters,
      so the gap is the split's arithmetic alone (gated).
    * ``one_process_vs_one_process``: that run's first moments against the
      one-process steps' (two one-process runs from parameters that differ
      only by the split's step-1 rounding), beside ``moved_at_step_1``,
      the entries whose first update took the other sign.
    * ``rows_reversed``: the one-process steps on the same batches with
      their rows in reverse order (the same loss; only the order of the
      sums over tokens differs) against the one-process steps: the moments
      after step 1 and after the last, and the entries moved at step 1."""
    from repro_torch.train.step import init_train_state
    from repro_torch.utils import tree

    t0 = time.perf_counter()

    def fresh():
        return init_train_state(one_model, torch.Generator(
            device=device).manual_seed(seed + 97))

    out = {"first_step": _tp_worst(_tp_mu_errs(paths, split_first["mu"],
                                               one_first["mu"])),
           "moved_at_step_1": _tp_moved(paths, split_first["params"],
                                        one_first["params"], lr)}
    # The second step from the split's state after step 1.
    st = fresh()
    with torch.no_grad():
        for dst, src in zip(tree.leaves(st["params"]), split_first["params"]):
            dst.copy_(src)
        for dst, src in zip(tree.leaves(st["opt"]["mu"]), split_first["mu"]):
            dst.copy_(src)
        for dst, src in zip(tree.leaves(st["opt"]["nu"]), one_first["nu"]):
            dst.copy_(src)
        st["opt"]["count"].copy_(one_first["count"])
    losses = []
    for i in range(1, steps):
        st, m = one_step(st, data(i))
        losses.append(float(m["loss"]))
    got = tree.leaves(st["opt"]["mu"])
    out["same_params"] = _tp_worst(_tp_mu_errs(paths, split_mu, got)) | {
        "losses": losses,
        "loss_rel_gap": [abs(a["loss"] - b) / abs(b)
                         for a, b in zip(split_rows[1:], losses)]}
    out["one_process_vs_one_process"] = _tp_worst(_tp_mu_errs(paths, got,
                                                              one_mu))
    del st, got
    # The one-process steps with each batch's rows reversed.
    st = fresh()
    rev = {}
    for i in range(steps):
        st, m = one_step(st, {k: np.ascontiguousarray(v[::-1])
                              for k, v in data(i).items()})
        rev.setdefault("losses", []).append(float(m["loss"]))
        if i == 0:
            snap = _tp_snapshot(st)
            rev["first_moments"] = _tp_worst(_tp_mu_errs(
                paths, snap["mu"], one_first["mu"]))
            rev["moved_at_step_1"] = _tp_moved(paths, snap["params"],
                                               one_first["params"], lr)
            del snap
    rev["last_moments"] = _tp_worst(_tp_mu_errs(
        paths, tree.leaves(st["opt"]["mu"]), one_mu))
    out["rows_reversed"] = rev
    del st
    out["seconds"] = time.perf_counter() - t0
    return out


def phase_train_tp(gpu: str, seed: int, arms, steps: int = 2) -> list:
    """Tensor-parallel ZeRO-1 training (``train.step`` over a (1, 4) mesh,
    the plain route as the trainer always is), every arm in one spawn of 4
    ranks that share the card over gloo, each rank holding its block of
    every leaf and of every moment (the vocab-parallel loss).  ``arms``:
    dicts with ``phase`` (the line's name), ``cfg``, ``shape`` (batch,
    tokens), ``cut``, ``ckpt`` (the whole state gathered into a
    checkpoint and restored at one rank; else only the first moments
    gathered) and ``witness``.  Gates: each step's loss within
    ``TP_LOSS_RTOL`` of the one-process step's and equal on every rank;
    the gathered first moments within ``TP_MU_TOL`` of each leaf's
    largest; with ``ckpt`` the gathered checkpoint restored at one rank
    bitwise.  With ``witness`` the first-moment gate is taken after the
    first step and after a second step from the split's own state
    (:func:`_tp_witness`), and the moments after the last step are
    reported beside two one-process-against-one-process gaps.  One line
    an arm."""
    import tempfile

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        _spawn(_tp_train_rank, TP_RANKS, tmp, seed, DEV, arms, steps)
        ranks_s = time.perf_counter() - t0
        res = [torch.load(f"{tmp}/tpt_rank{r}.pt", weights_only=False)
               for r in range(TP_RANKS)]
    lines = []
    for arm in arms:
        cfg, name = arm["cfg"], arm["phase"]
        rs = [r[name] for r in res]
        r0 = rs[0]
        losses = [[row["loss"] for row in r["steps"]] for r in rs]
        if any(lo != losses[0] for lo in losses):
            raise AssertionError(f"{name}: the ranks' losses differ: "
                                 f"{losses}")
        one = [row["loss"] for row in r0["one_process"]]
        gaps = [abs(a - b) / abs(b) for a, b in zip(losses[0], one)]
        wit = r0.get("witness")
        if wit is None:
            mu = {"after": f"step {steps}", "rel_err": r0["mu_rel_err"],
                  "leaf": r0["mu_worst_leaf"]}
            gated, loss_gaps = [mu], gaps
        else:
            mu = dict(wit.pop("first_step"), after="step 1")
            same = dict(wit["same_params"], after=f"step {steps} from the "
                        f"split's state after step 1")
            gated, loss_gaps = [mu, same], gaps + same["loss_rel_gap"]
        bad = [g for g in gated if not g["rel_err"] <= TP_MU_TOL]
        if not max(loss_gaps) <= TP_LOSS_RTOL or bad:
            raise AssertionError(
                f"{name}: the split steps are not the one-process steps "
                f"(losses {losses[0]} vs {one}, relative gaps "
                f"{loss_gaps}, "
                f"limit {TP_LOSS_RTOL}; first moments "
                + "; ".join(f"{g['rel_err']:.3e} of a leaf's largest after "
                            f"{g['after']} at {g['leaf']}" for g in gated)
                + f", limit {TP_MU_TOL})")
        if arm["ckpt"] and not r0["restore_bitwise"]:
            raise AssertionError(f"{name}: the gathered checkpoint did not "
                                 f"restore bitwise at one rank")
        if not all(math.isfinite(x) for x in losses[0]):
            raise AssertionError(f"{name}: non-finite loss {losses[0]}")
        out = {"phase": name, "gpu": gpu, "arch": cfg.arch,
               "family": cfg.family, "n_layers": cfg.n_layers,
               "dtype": cfg.dtype, "cut": arm["cut"],
               "ranks": TP_RANKS, "mesh": [1, TP_RANKS], "backend": "gloo",
               "route": "xla", "zero1": True, "batch": list(arm["shape"]),
               "steps": steps, "losses": losses[0],
               "one_process_losses": one, "loss_rel_gap": gaps,
               "mu_rel_err": mu["rel_err"], "mu_worst_leaf": mu["leaf"],
               "mu_after": mu["after"],
               "grad_norm": [row["grad_norm"] for row in r0["steps"]],
               "one_process_grad_norm": [row["grad_norm"]
                                         for row in r0["one_process"]],
               "tol": f"loss rtol {TP_LOSS_RTOL}, equal across ranks; first "
                      f"moments {TP_MU_TOL} of each leaf's largest after "
                      + " and after ".join(g["after"] for g in gated),
               "step_ms": [[row["ms"] for row in r["steps"]] for r in rs],
               "one_process_step_ms": [row["ms"]
                                       for row in r0["one_process"]],
               "collective_ms": [[row["collective_ms"] for row in r["steps"]]
                                 for r in rs],
               "staged_collectives": [r["steps"][-1]["staged_collectives"]
                                      for r in rs],
               "staged_bytes": [r["steps"][-1]["staged_bytes"] for r in rs],
               "state_bytes": [r["state_bytes"] for r in rs],
               "max_memory_allocated": [r["max_memory_allocated"]
                                        for r in rs],
               "gathered": ("state" if arm["ckpt"] else "first moments") + (
                   "; parameters and first moments after step 1"
                   if wit else ""),
               "gather_s": [r["gather_s"] for r in rs]}
        if wit is not None:
            out["witness"] = dict(wit, last_moments={
                "after": f"step {steps}", "rel_err": r0["mu_rel_err"],
                "leaf": r0["mu_worst_leaf"]})
        if arm["ckpt"]:
            out.update({"restore_1_rank_bitwise": True,
                        "param_max_abs_diff": r0["param_max_abs_diff"],
                        "ckpt_bytes": r0["ckpt_bytes"],
                        "ckpt_save_s": r0["ckpt_save_s"],
                        "ckpt_restore_s": r0["ckpt_restore_s"]})
        out.update({
            "timing": "host clock; each step starts after a barrier with "
                      "the collectives clocked (tensor_parallel.CLOCK: a "
                      "device sync before and after each, the host staging "
                      "included); the ranks run at once on one card; "
                      "ranks_s and phase_s: the one spawn and the whole "
                      "phase, shared by the train_tp lines",
            "ranks_s": ranks_s})
        lines.append(out)
    phase_s = time.perf_counter() - t_phase
    for out in lines:
        out["phase_s"] = phase_s
        emit(out)
    return lines


PTXAS_REPORT = ("decode_attention", "flash_attention", "matmul", "ssd",
                "fused_norm", "moe_gmm")


def ptxas_report(source: pathlib.Path) -> list[dict]:
    """Registers, static shared memory and spills of each kernel in
    ``source``, from ``nvcc -Xptxas -v`` with the build's flags."""
    import re

    from repro_torch.kernels.common import NVCC_FLAGS, _nvcc

    flags = [f for f in NVCC_FLAGS if f not in ("-shared", "-Xcompiler",
                                                "-fPIC")]
    proc = subprocess.run(
        [_nvcc(), *flags, "-Xptxas", "-v", "-cubin", "-o", "/dev/null",
         str(source)], capture_output=True, text=True, check=True,
        timeout=600)
    rows, name = [], None
    for line in proc.stderr.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            # e.g. ..._ZN..16flash_mma_kernelILi80EEEvNS_4ArgsE ->
            # flash_mma_kernel<80>; ..15mm_small_kernelILi1ELi128EfEEv.. ->
            # mm_small_kernel<1,128,float>; a repeated type is a
            # substitution (S1_), here always bf16
            k = re.search(r"\d+([a-z][a-z_]*_kernel)I((?:Li\d+E|Lb[01]E"
                          r"|13__nv_bfloat16|S\d*_|f)+)E", m.group(1))
            args = [t.group(1) or {"Lb1E": "true", "Lb0E": "false",
                                   "f": "float"}.get(t.group(0), "bf16")
                    for t in re.finditer(r"Li(\d+)E|Lb[01]E|13__nv_bfloat16"
                                         r"|S\d*_|f", k.group(2))] if k else []
            name = (f"{k.group(1)}<{','.join(args)}>" if k
                    else m.group(1))
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and name:
            rows.append({"kernel": name, "stack_frame": int(m.group(1)),
                         "spill_stores": int(m.group(2)),
                         "spill_loads": int(m.group(3))})
        m = re.search(r"Used (\d+) registers", line)
        if m and rows and rows[-1]["kernel"] == name:
            smem = re.search(r"(\d+) bytes smem", line)
            rows[-1] |= {"registers": int(m.group(1)),
                         "static_smem": int(smem.group(1)) if smem else 0}
    return rows


def build_kernels() -> tuple[float, dict]:
    """Build every kernel (one nvcc per source, started together, beside
    the ptxas reports of PTXAS_REPORT), then load each; returns
    the seconds it took and the reports."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels.common import build_library

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(SOURCES) + len(PTXAS_REPORT)) as pool:
        reports = {n: pool.submit(ptxas_report, ROOT / SOURCES[n])
                   for n in PTXAS_REPORT}
        list(pool.map(build_library, (ROOT / s for s in SOURCES.values())))
        reports = {n: f.result() for n, f in reports.items()}
    for mod in _kernel_modules():
        mod._kernel()
    return time.perf_counter() - t0, reports


# How the kernels line's ``launches`` were counted on the main paths.
COUNTED = ("decode chunks (plain and speculative): the capture's "
           "launches x graph replays, one "
           "replay's kernels held to them by the profiler "
           "(check_replay_kernels); prefill, the policy matmul and the "
           "trainer's kernel-route forward: at each launch; "
           "decode_attention: the cross-attention steps of the "
           "fixed-source arms, the pallas_gather twins and sp_decode's "
           "ranks (one launch a rank a case, counted in each rank); "
           "tp_forward (phi3.5-moe, whisper-small, the VLM, mamba2 and "
           "zamba2): each rank's counted forward, summed over the ranks")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only",
              file=sys.stderr)
        return 1
    from repro_torch.configs import (
        granite_20b,
        llama32_vision_90b,
        mamba2_13b,
        minicpm_2b,
        olmoe_1b_7b,
        phi35_moe,
        whisper_small,
        yi_9b,
        zamba2_27b,
    )

    from repro_torch import hw

    gpu = card_line()
    props = torch.cuda.get_device_properties(0)
    build_s, ptxas = build_kernels()
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
          "build_s": build_s, "ptxas": ptxas})
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
    serve = phase_serve(
        gpu, args.seed, dataclasses.replace(yi_9b.CONFIG, **paged),
        twins=(),
        cut="the eager and pallas_gather twins: the run's 1200 s limit (the "
            "Mamba-2 and zamba2 tensor-parallel arms took the time; a proof "
            "run took 1127.4 s); zamba2, mamba2, olmoe and whisper keep "
            "theirs")
    # The prefix, adaptive, sampling and snapshot arms run yi-9b's first
    # 12 layers: their gates (hits, preemptions, invariants, placement,
    # prefill work, streams bitwise against the eager loop and across a
    # restore) do not depend on depth, and the run has a time limit.
    cut12 = ("n_layers 48 -> 12: the run's 1200 s limit (the trainer "
             "phases took the time)")
    cut12_tp = ("n_layers 48 -> 12: the run's 1200 s limit (the "
                "tensor-parallel whisper and VLM arms took the time)")
    cfg12, params12 = _cut_depth(serve["cfg"], serve["params"], 12)
    phase_prefix(gpu, args.seed, cfg12, params12, cut=cut12)
    served["yi-9b"] = serve
    # Speculative decode and the adaptive policy at yi-9b's width.
    served["yi-9b spec"] = phase_serve_spec(gpu, args.seed, serve["cfg"],
                                            serve["params"], "serve_spec")
    served["yi-9b adaptive"] = phase_serve_adaptive(gpu, cfg12, params12,
                                                    cut=cut12)
    # Seeded top-p sampling, then crash safety and KV page integrity.
    served["yi-9b sampling"] = phase_serve_sampling(
        gpu, args.seed, cfg12, params12, cut=cut12_tp)
    served["yi-9b integrity"] = phase_serve_snapshot(
        gpu, args.seed, cfg12, params12, cut=cut12_tp)
    del cfg12, params12
    del serve["params"]
    torch.cuda.empty_cache()
    zserve = phase_serve(gpu, args.seed,
                         dataclasses.replace(zamba2_27b.CONFIG, **paged),
                         "serve_zamba2", twins=("gather",),
                         cut="the eager twin: the run's 1200 s limit (a "
                             "proof run with the Mamba-2 and zamba2 "
                             "tensor-parallel arms took 1111.2 s); mamba2, "
                             "olmoe and whisper keep theirs")
    phase_preempt(gpu, args.seed, zserve["cfg"], zserve["params"],
                  zserve["reqs"])
    served["zamba2-2.7b"] = zserve
    # Its replay rollback at 3 of the 9 shared-attention groups.
    cfg18, params18 = _cut_depth(zserve["cfg"], zserve["params"], 18)
    served["zamba2-2.7b spec"] = phase_serve_spec(
        gpu, args.seed, cfg18, params18, "serve_spec_zamba2",
        cut="n_layers 54 -> 18 (3 shared-attention groups): the run's "
            "1200 s limit (the trainer phases took the time)")
    del cfg18, params18
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
    # The last two dense configs: granite's MQA (48 query heads over one
    # KV head) and GELU MLP, minicpm's tied embeddings and 36 heads of 64.
    for mod, name in ((granite_20b, "serve_granite"),
                      (minicpm_2b, "serve_minicpm")):
        dserve = phase_serve(gpu, args.seed,
                             dataclasses.replace(mod.CONFIG, **paged), name,
                             twins=(), trace=False)
        served[mod.CONFIG.arch] = dserve
        del dserve["params"]
        torch.cuda.empty_cache()
    # The fixed-source families: whisper-small at full depth (12 encoder
    # and 12 decoder layers; the encoder and the cross K/V run at each
    # engine's construction) and llama-3.2-vision-90b at full width, its
    # depth cut to fit the card.
    wserve = phase_serve(gpu, args.seed,
                         dataclasses.replace(whisper_small.CONFIG, **paged),
                         "serve_whisper")
    served["whisper-small"] = wserve
    del wserve["params"]
    torch.cuda.empty_cache()
    vserve = phase_serve(
        gpu, args.seed,
        dataclasses.replace(llama32_vision_90b.CONFIG, n_layers=20, **paged),
        "serve_vlm", twins=(), trace=False,
        cut=("n_layers 100 -> 20 (4 groups of 4 self layers and 1 cross "
             "layer): the 100 layers' bf16 weights (~171 GB) exceed one "
             "card"))
    served["llama-3.2-vision-90b"] = vserve
    del vserve["params"]
    torch.cuda.empty_cache()
    # fp32 speculative streams bitwise equal to plain ones: rewind (yi-9b
    # at 4 layers) and replay (zamba2 at 6: one shared-attention group).
    emit({"phase": "spec_identity", "gpu": gpu, "rows": [
        phase_spec_identity(args.seed,
                            dataclasses.replace(yi_9b.CONFIG, **paged), 4),
        phase_spec_identity(args.seed,
                            dataclasses.replace(zamba2_27b.CONFIG, **paged),
                            6)]})
    # Seeded sampling's identities, torch against torch, bitwise in fp32.
    emit({"phase": "sampling_identity", "gpu": gpu, "rows": [
        phase_sampling_identity(args.seed,
                                dataclasses.replace(yi_9b.CONFIG, **paged), 4),
        phase_sampling_identity(
            args.seed, dataclasses.replace(zamba2_27b.CONFIG, **paged), 6)]})
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
    # whisper-small at full width and depth (its encoder, cross prefill
    # and cross decode on both routes): fp32 within 2e-3, then the bf16
    # routes' gap, measured.
    whisper = dataclasses.replace(whisper_small.CONFIG, cache_layout="paged",
                                  kv_page_size=PSZ)
    phase_e2e(gpu, args.seed, dataclasses.replace(whisper, dtype="float32"))
    phase_e2e(gpu, args.seed, whisper, gated=False)
    torch.cuda.empty_cache()
    # The trainer at minicpm-2b's full width: forward on the kernel route
    # (fp32 at 4 layers, gated; bf16 at full depth, the gap), the three
    # activation policies at 4 layers, the train step at full depth, and
    # checkpoints with the loop at 2 layers.
    minicpm = minicpm_2b.CONFIG
    fwd = [phase_forward_kernels(
               gpu, args.seed,
               dataclasses.replace(minicpm, n_layers=4, dtype="float32")),
           phase_forward_kernels(gpu, args.seed, minicpm, gated=False)]
    served["minicpm-2b forward"] = {"launches": {
        k: fwd[0]["launches"][k] + fwd[1]["launches"][k]
        for k in fwd[0]["launches"]}}
    torch.cuda.empty_cache()
    rem = phase_train_remat(
        gpu, args.seed, dataclasses.replace(minicpm, n_layers=4),
        cut="n_layers 40 -> 4: SAVE_ALL's activations at 40 layers exceed "
            "the card")
    torch.cuda.empty_cache()
    phase_train_minicpm(
        gpu, args.seed, minicpm,
        per_layer_save_all=rem["policies"]["save_all"][
            "per_layer_saved_bytes"])
    torch.cuda.empty_cache()
    phase_train_resume(
        gpu, args.seed, dataclasses.replace(minicpm, n_layers=2),
        cut="n_layers 40 -> 2: a checkpoint's bytes (its write and read) "
            "and three train states")
    torch.cuda.empty_cache()
    # The paper's 17 workloads; sequence-parallel decode over 4 ranks that
    # share the card (yi-9b's attention at long_500k); data-parallel
    # ZeRO-1 training of minicpm-2b over 2 ranks.
    phase_suite(gpu, args.seed)
    sp = phase_sp_decode(gpu, args.seed)
    served["sp_decode"] = {"launches": {
        **{k: 0 for k in counts()}, "decode_dense": sp["launches"]}}
    torch.cuda.empty_cache()
    phase_train_dp(
        gpu, args.seed,
        dataclasses.replace(minicpm, n_layers=2, dtype="float32"),
        dataclasses.replace(minicpm, n_layers=2),
        cut="n_layers 40 -> 2 (the measured arm): two ranks' bf16 states "
            "and fp32 gradients on one card, and the run's 1200 s limit "
            "(8 -> 4 once tp_forward and train_tp took the run past 1120 "
            "s, 4 -> 2 once the Mamba-2 and zamba2 arms took a proof run "
            "to 1127.4 s)")
    torch.cuda.empty_cache()
    # Tensor and expert parallel execution over 4 ranks that share the
    # card: phi3.5-moe's forward on the kernel route (its local experts
    # through the grouped GEMM), whisper-small's and the VLM's (flash
    # without the mask over their sources), mamba2's and zamba2's (the
    # SSD scan on a rank's heads) in the same spawn; yi-9b's,
    # whisper-small's and zamba2's ZeRO-1 train steps.
    route = dict(decode_kernel="pallas_paged")
    phi = dataclasses.replace(phi35_moe.CONFIG, **route)
    wsp = dataclasses.replace(whisper_small.CONFIG, **route)
    vlm = dataclasses.replace(llama32_vision_90b.CONFIG, **route)
    mb = dataclasses.replace(mamba2_13b.CONFIG, **route)
    zb = dataclasses.replace(zamba2_27b.CONFIG, **route)
    ssm_cut = ("n_layers {L} -> 12{g}: the run's 1200 s limit (each layer "
               "stages its gathered in_proj and conv outputs through the "
               "host, twice as many bytes in fp32)")
    vlm_cut = ("n_layers 100 -> {n} ({g} group(s) of 4 self layers and 1 "
               "cross layer): the weights once in this process and once "
               "over the ranks (~{gb} GB each), and the run's 1200 s limit; "
               "2 x 256 tokens (not 4 x 512): the gathered logits (4 x 512 "
               "x 128256 fp32, 1.05 GB) go through the host each forward")
    tpf = phase_tp_forward(gpu, args.seed, [
        {"phase": "tp_forward", "shape": (4, 512),
         "gate": dataclasses.replace(phi, n_layers=2, dtype="float32"),
         "measured": dataclasses.replace(phi, n_layers=8),
         "cut": {"gate": "n_layers 32 -> 2: the fp32 weights once in this "
                         "process and once over the ranks (~11.4 GB each)",
                 "measured": "n_layers 32 -> 8: the bf16 weights once in "
                             "this process and once over the ranks (~21.4 "
                             "GB each), and the run's 1200 s limit"}},
        {"phase": "tp_forward_whisper", "shape": (4, 448),
         "gate": dataclasses.replace(wsp, dtype="float32"),
         "measured": wsp, "cut": {"gate": None, "measured": None}},
        {"phase": "tp_forward_vlm", "shape": (2, 256),
         "gate": dataclasses.replace(vlm, n_layers=5, dtype="float32"),
         "measured": dataclasses.replace(vlm, n_layers=10),
         "cut": {"gate": vlm_cut.format(n=5, g=1, gb=26),
                 "measured": vlm_cut.format(n=10, g=2, gb=21)}},
        {"phase": "tp_forward_mamba2", "shape": (2, 256),
         "gate": dataclasses.replace(mb, n_layers=12, dtype="float32"),
         "measured": mb,
         "cut": {"gate": ssm_cut.format(L=48, g=""), "measured": None}},
        {"phase": "tp_forward_zamba2", "shape": (2, 256),
         "gate": dataclasses.replace(zb, n_layers=12, dtype="float32"),
         "measured": zb,
         "cut": {"gate": ssm_cut.format(L=54, g=" (two groups of 6 "
                                              "Mamba-2 layers and the "
                                              "shared block)"),
                 "measured": None}}])
    served["tp_forward"] = {"launches": {
        **{k: 0 for k in counts()}, **tpf["total_launches"]}}
    torch.cuda.empty_cache()
    phase_train_tp(gpu, args.seed, [
        {"phase": "train_tp", "shape": (4, 512), "ckpt": False,
         "cfg": dataclasses.replace(yi_9b.CONFIG, n_layers=2,
                                    dtype="float32"),
         "cut": "n_layers 48 -> 2: the fp32 state (~14 GB) once over the "
                "ranks and once in rank 0's one-process steps, and the "
                "run's 1200 s limit; only the first moments gathered, no "
                "checkpoint (its ~10.6 GB gathered, written and read took "
                "~40 s; train_tp_whisper's carries the one-rank restore)"},
        {"phase": "train_tp_whisper", "shape": (2, 448), "ckpt": True,
         "cfg": dataclasses.replace(whisper_small.CONFIG, dtype="float32"),
         "cut": None},
        {"phase": "train_tp_zamba2", "shape": (2, 256), "ckpt": False,
         "witness": True,
         "cfg": dataclasses.replace(zamba2_27b.CONFIG, n_layers=6,
                                    dtype="float32"),
         "cut": "n_layers 54 -> 6 (one group of 6 Mamba-2 layers and the "
                "shared block): the run's 1200 s limit; only the first "
                "moments gathered, no checkpoint (the CPU tests restore "
                "mamba2's)"}])
    torch.cuda.empty_cache()

    def launched(*keys, runs=("launches",)):
        """(total, by path) of the main paths' launches of ``keys``, over
        the runs named (the arms' main runs, their pallas_gather twins)."""
        by_path = {(arch if r == "launches" else f"{arch} ({r})"):
                   sum(run[r][k] for k in keys)
                   for arch, run in served.items() for r in runs if r in run}
        return sum(by_path.values()), by_path

    dec = kern["main"]
    rows = [("paged_decode_attention", "decode_attention",
             launched("decode_paged"), kern["errs"]["paged_decode_attention"],
             dict(dec, ms=dec["paged_ms"])),
            ("decode_attention", "decode_attention",
             launched("decode_dense", runs=("launches", "gather_launches")),
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
            "launches_by_path": by_path, "launches_counted": COUNTED,
            "max_abs_err": err,
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
        })
    # The grouped GEMM's main-path launches by body, and its decode shape
    # (the decode body's row of kernels_gmm) beside the prefill one.
    gsum = next(r for r in summary if r["name"] == "grouped_matmul")
    gsum["launches_by_body"] = served["olmoe-1b-7b"]["gmm_bodies"]
    gsum["decode_shape"] = {key: gmm["decode"][key] for key in (
        "shape", "body", "ms", "plain_ms", "bound_ms", "bound_by",
        "library_ms", "over_bound")}
    # The flash kernel at the speculative verify's shape (q_len 5).
    fsum = next(r for r in summary if r["name"] == "flash_attention")
    fsum["verify_shape"] = {key: flash["verify"][key] for key in (
        "shape", "body", "ms", "plain_ms", "bound_ms", "bound_by",
        "library_ms", "over_bound")}
    # The fixed-source families' shapes: the dense decode kernel over the
    # cross K/V, flash without the causal mask, the norm at their widths.
    keys = ("shape", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "over_bound")
    dsum = next(r for r in summary if r["name"] == "decode_attention")
    dsum["cross_shapes"] = [{key: row[key] for key in ("case", "splits")
                             + keys} for row in kern["cross"]]
    fsum["encoder_shape"] = {key: flash["encoder"][key]
                             for key in ("body",) + keys}
    fsum["cross_shape"] = {key: flash["cross"][key]
                           for key in ("body",) + keys}
    nsum = next(r for r in summary if r["name"] == "fused_norm")
    nsum["source_shapes"] = [{key: row[key] for key in ("kind", "body")
                              + keys} for row in norm["source"]]
    emit({"kernels": summary})
    print(gpu, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
