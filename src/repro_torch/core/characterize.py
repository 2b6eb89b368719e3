"""Analytical access-pattern characterization of MI operators.

A copy of ``repro.core.characterize`` (host-side Python and numpy), line for
line: the port keeps its own so it never imports the JAX package, and
its plans and modeled costs equal the reference's with ``==``.

This module builds :class:`OperandProfile`/:class:`OpSpec` descriptions of the
operator kinds that make up the paper's 17 workloads and our model zoo, and
implements the paper's §VI.A three-way workload classification.

All reuse math assumes a canonical blocked schedule with MXU-aligned default
tiles (the same defaults the allocator starts from), because on TPU the
schedule — not a hardware replacement policy — determines how many times an
operand is fetched.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch import hw
from repro_torch.core.policy import (
    OperandProfile,
    OpSpec,
    StaticMode,
    WorkloadClass,
    reuse_density,
    static_assignment,
)

# Canonical tile sizes used for reuse accounting (allocator defaults).
DEF_BM = 256
DEF_BN = 256
DEF_BK = 256
DEF_BQ = 256
DEF_BKV = 256


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def matmul_op(
    m: int,
    k: int,
    n: int,
    dtype: str = "bf16",
    out_dtype: str | None = None,
    bm: int = DEF_BM,
    bn: int = DEF_BN,
    bk: int = DEF_BK,
    split_k: int = 1,
    name: str = "matmul",
) -> OpSpec:
    """C[M,N] = A[M,K] @ B[K,N] under an (m, n, k) blocked schedule.

    Output revisits: register/VMEM accumulation over the in-kernel k loop is
    intrinsic to any GEMM kernel (not a cache-policy choice), so the output
    is written once unless the schedule splits K across grid workers
    (``split_k`` > 1), in which case partial sums write through per split —
    that is the access the write-coalescing policy targets.
    """
    eb = hw.dtype_bytes(dtype)
    ob = hw.dtype_bytes(out_dtype or dtype)
    bm, bn, bk = min(bm, m), min(bn, n), min(bk, k)
    n_blocks = _ceil_div(n, bn)
    m_blocks = _ceil_div(m, bm)
    k_rev = max(1, split_k)
    # Reuse windows are BAND-sized, not operand-sized: a blocked schedule
    # captures A's cross-(n-block) reuse by keeping one m-band of A (bm x K)
    # live, and B's cross-(m-block) reuse with one k-band of B (bk x N).
    # This is what lets the paper's 4MB GPU L2 cut FwFc DRAM traffic 93%
    # even though the whole B matrix is 37x the cache.
    a = OperandProfile(
        name="a", role="input", shape=(m, k), dtype=dtype,
        unique_bytes=m * k * eb,
        touched_bytes_stream=m * k * eb * n_blocks,   # refetched per n-block
        reuse_window_bytes=min(m, bm) * k * eb,       # one m-band of A
        contiguity=1.0,
    )
    b = OperandProfile(
        name="b", role="input", shape=(k, n), dtype=dtype,
        unique_bytes=k * n * eb,
        touched_bytes_stream=k * n * eb * m_blocks,   # refetched per m-block
        reuse_window_bytes=min(k, bk) * n * eb,       # one k-band of B
        contiguity=1.0,
    )
    c = OperandProfile(
        name="out", role="output", shape=(m, n), dtype=out_dtype or dtype,
        unique_bytes=m * n * ob,
        touched_bytes_stream=m * n * ob,
        revisits=k_rev,
        contiguity=1.0,
    )
    return OpSpec(
        kind="matmul", name=name, operands=(a, b, c),
        flops=2.0 * m * n * k, dtype=dtype,
        meta={"m": m, "n": n, "k": k, "bm": bm, "bn": bn, "bk": bk},
    )


def attention_op(
    batch: int,
    q_heads: int,
    kv_heads: int,
    sq: int,
    skv: int,
    head_dim: int,
    causal: bool = True,
    dtype: str = "bf16",
    bq: int = DEF_BQ,
    bkv: int = DEF_BKV,
    name: str = "attention",
) -> OpSpec:
    """Flash-style attention: outer loop over q blocks, inner over kv blocks."""
    eb = hw.dtype_bytes(dtype)
    bq, bkv = min(bq, sq), min(bkv, skv)
    q_blocks = _ceil_div(sq, bq)
    kv_rev = _ceil_div(skv, bkv)
    frac = 0.5 if (causal and sq == skv) else 1.0
    group = max(1, q_heads // max(1, kv_heads))
    q = OperandProfile(
        name="q", role="input", shape=(batch, q_heads, sq, head_dim), dtype=dtype,
        unique_bytes=batch * q_heads * sq * head_dim * eb,
        touched_bytes_stream=batch * q_heads * sq * head_dim * eb,
        reuse_window_bytes=bq * head_dim * eb,
    )
    # K/V are refetched for each q block of each of the `group` q heads that
    # share them (GQA reuse) — per (batch, kv_head) the window is skv*d.
    kv_unique = batch * kv_heads * skv * head_dim * eb
    kv_touch = int(kv_unique * q_blocks * group * frac)
    k = OperandProfile(
        name="k", role="input", shape=(batch, kv_heads, skv, head_dim), dtype=dtype,
        unique_bytes=kv_unique, touched_bytes_stream=max(kv_unique, kv_touch),
        reuse_window_bytes=skv * head_dim * eb,
    )
    v = OperandProfile(
        name="v", role="input", shape=(batch, kv_heads, skv, head_dim), dtype=dtype,
        unique_bytes=kv_unique, touched_bytes_stream=max(kv_unique, kv_touch),
        reuse_window_bytes=skv * head_dim * eb,
    )
    o = OperandProfile(
        name="out", role="output", shape=(batch, q_heads, sq, head_dim), dtype=dtype,
        unique_bytes=batch * q_heads * sq * head_dim * eb,
        touched_bytes_stream=batch * q_heads * sq * head_dim * eb,
        revisits=max(1, int(kv_rev * frac)),
    )
    return OpSpec(
        kind="attention", name=name, operands=(q, k, v, o),
        flops=4.0 * batch * q_heads * sq * skv * head_dim * frac, dtype=dtype,
        meta={
            "batch": batch, "q_heads": q_heads, "kv_heads": kv_heads,
            "sq": sq, "skv": skv, "head_dim": head_dim, "causal": causal,
            "bq": bq, "bkv": bkv,
        },
    )


def elementwise_op(
    elems: int,
    n_inputs: int = 1,
    n_outputs: int = 1,
    flops_per_elem: float = 1.0,
    dtype: str = "bf16",
    name: str = "elementwise",
) -> OpSpec:
    """Pure streaming map (activations, residual adds, scaling): reuse = 1."""
    eb = hw.dtype_bytes(dtype)
    ops = []
    for i in range(n_inputs):
        ops.append(OperandProfile(
            name=f"in{i}", role="input", shape=(elems,), dtype=dtype,
            unique_bytes=elems * eb, touched_bytes_stream=elems * eb,
        ))
    for i in range(n_outputs):
        ops.append(OperandProfile(
            name=f"out{i}" if n_outputs > 1 else "out", role="output",
            shape=(elems,), dtype=dtype,
            unique_bytes=elems * eb, touched_bytes_stream=elems * eb, revisits=1,
        ))
    return OpSpec(kind="elementwise", name=name, operands=tuple(ops),
                  flops=flops_per_elem * elems, dtype=dtype,
                  meta={"elems": elems})


def rowwise_op(
    rows: int,
    row_len: int,
    passes: int = 3,
    flops_per_elem: float = 4.0,
    dtype: str = "bf16",
    name: str = "softmax",
) -> OpSpec:
    """Multi-pass row reduction+map (softmax, layer/batch-norm apply).

    Streaming executes ``passes`` sweeps over the input (max, sum,
    normalize); caching a row (window = one row) captures the reuse.
    """
    eb = hw.dtype_bytes(dtype)
    elems = rows * row_len
    x = OperandProfile(
        name="x", role="input", shape=(rows, row_len), dtype=dtype,
        unique_bytes=elems * eb, touched_bytes_stream=elems * eb * passes,
        reuse_window_bytes=row_len * eb,
    )
    o = OperandProfile(
        name="out", role="output", shape=(rows, row_len), dtype=dtype,
        unique_bytes=elems * eb, touched_bytes_stream=elems * eb, revisits=1,
    )
    return OpSpec(kind="rowwise", name=name, operands=(x, o),
                  flops=flops_per_elem * elems * passes, dtype=dtype,
                  meta={"rows": rows, "row_len": row_len, "passes": passes})


def window_op(
    elems: int,
    window: int,
    stride_elems: int,
    reuse_distance_elems: int,
    loads_per_out: float | None = None,
    out_elems: int | None = None,
    flops_per_out: float = 2.0,
    dtype: str = "bf16",
    name: str = "window",
) -> OpSpec:
    """Windowed gather ops (pooling, LRN): each output reads ``window`` inputs.

    ``reuse_distance_elems`` is the element spacing between successive touches
    of the same input (stride-1 spatial window -> small; cross-channel LRN ->
    H*W, typically exceeding VMEM, making the reuse unrealizable — the
    paper's FwLRN case).
    """
    eb = hw.dtype_bytes(dtype)
    out_elems = out_elems if out_elems is not None else max(1, elems // max(1, stride_elems))
    loads = loads_per_out if loads_per_out is not None else float(window)
    touched = int(out_elems * loads * eb)
    x = OperandProfile(
        name="x", role="input", shape=(elems,), dtype=dtype,
        unique_bytes=elems * eb, touched_bytes_stream=max(elems * eb, touched),
        reuse_window_bytes=max(1, reuse_distance_elems) * eb,
        contiguity=1.0 if reuse_distance_elems <= 4096 else 0.8,
    )
    o = OperandProfile(
        name="out", role="output", shape=(out_elems,), dtype=dtype,
        unique_bytes=out_elems * eb, touched_bytes_stream=out_elems * eb, revisits=1,
    )
    return OpSpec(kind="window", name=name, operands=(x, o),
                  flops=flops_per_out * out_elems, dtype=dtype,
                  meta={"elems": elems, "window": window,
                        "reuse_distance_elems": reuse_distance_elems})


def conv2d_op(
    n: int, c_in: int, h: int, w: int, c_out: int, kh: int, kw: int,
    stride: int = 1, dtype: str = "bf16", name: str = "conv2d",
) -> OpSpec:
    """Conv as implicit GEMM: M = N*Ho*Wo, K = Cin*kh*kw, N = Cout."""
    ho, wo = max(1, h // stride), max(1, w // stride)
    op = matmul_op(n * ho * wo, c_in * kh * kw, c_out, dtype=dtype, name=name)
    # im2col touches each input element kh*kw/stride^2 times with a small
    # reuse window (rows of the image).
    eb = hw.dtype_bytes(dtype)
    in_elems = n * c_in * h * w
    x = OperandProfile(
        name="a", role="input", shape=(n, c_in, h, w), dtype=dtype,
        unique_bytes=in_elems * eb,
        touched_bytes_stream=int(in_elems * eb * max(1.0, kh * kw / stride**2)),
        reuse_window_bytes=c_in * kw * w * eb * kh,
    )
    ops = tuple(x if o.name == "a" else o for o in op.operands)
    return OpSpec(kind="conv2d", name=name, operands=ops, flops=op.flops,
                  dtype=dtype, meta={**op.meta, "kh": kh, "kw": kw})


# ---------------------------------------------------------------------------
# Vectorized operand tensors (consumed by core.sweep)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class OpTensors:
    """Per-operand byte/flop arrays for one op, precomputed once.

    Inputs are stored in *residency-priority order* (reuse density
    descending) — the order ``plan_residency`` allocates the VMEM budget —
    so the sweep kernel can realize partial residency with a cumulative
    sum instead of re-sorting per assignment.
    """

    in_names: tuple[str, ...]        # density-ordered
    in_unique: np.ndarray            # [I] float64
    in_touched: np.ndarray           # [I]
    in_window: np.ndarray            # [I]
    out_names: tuple[str, ...]
    out_unique: np.ndarray           # [O]
    out_writethrough: np.ndarray     # [O] unique * max(1, 2*revisits - 1)
    out_contiguity: np.ndarray       # [O]
    flops: float
    achieved_eff: float | None       # meta override, None -> calib default

    @property
    def n_inputs(self) -> int:
        return len(self.in_names)

    @property
    def n_outputs(self) -> int:
        return len(self.out_names)


def operand_tensors(op: OpSpec) -> OpTensors:
    """Build the sweep kernel's array view of one op (calib-independent)."""
    ins = sorted(op.inputs, key=reuse_density, reverse=True)
    outs = op.outputs
    eff = op.meta.get("achieved_eff")
    return OpTensors(
        in_names=tuple(o.name for o in ins),
        in_unique=np.array([o.unique_bytes for o in ins], dtype=np.float64),
        in_touched=np.array(
            [o.touched_bytes_stream for o in ins], dtype=np.float64
        ),
        in_window=np.array([o.window_bytes for o in ins], dtype=np.float64),
        out_names=tuple(o.name for o in outs),
        out_unique=np.array([o.unique_bytes for o in outs], dtype=np.float64),
        out_writethrough=np.array(
            [o.unique_bytes * max(1, 2 * o.revisits - 1) for o in outs],
            dtype=np.float64,
        ),
        out_contiguity=np.array([o.contiguity for o in outs], dtype=np.float64),
        flops=op.flops,
        achieved_eff=None if eff is None else float(eff),
    )


# ---------------------------------------------------------------------------
# Workload classification (paper §VI.A)
# ---------------------------------------------------------------------------

def classify_workload(
    ops: list[OpSpec],
    chip: hw.Chip = hw.V5E,
    threshold: float = 0.05,
    memoize: bool = True,
    plan_cache=None,
    cost_fn=None,
) -> WorkloadClass:
    """Reproduce the paper's 3-way grouping from modeled policy sensitivity.

    ``cost_fn(ops, mode) -> CostBreakdown`` overrides the cost evaluator
    (e.g. a vectorized :class:`~repro.core.sweep.SweepTable`); the default
    is the scalar (memoized) ``workload_cost``.
    """
    from repro_torch.core.cost_model import workload_cost  # local: avoid import cycle

    if cost_fn is None:
        def cost_fn(ops, mode):
            return workload_cost(ops, mode=mode, chip=chip, launches_per_op=0,
                                 memoize=memoize, plan_cache=plan_cache)

    times = {
        # Launch overhead excluded: classification concerns memory behaviour.
        mode: cost_fn(ops, mode).t_total
        for mode in (StaticMode.UNCACHED, StaticMode.CACHER, StaticMode.CACHERW)
    }
    t_unc = times[StaticMode.UNCACHED]
    t_best = min(times.values())
    t_worst = max(times.values())
    if t_best <= 0 or (t_worst - t_best) / max(t_best, 1e-30) < threshold:
        return WorkloadClass.MEMORY_INSENSITIVE
    cached_best = min(times[StaticMode.CACHER], times[StaticMode.CACHERW])
    if cached_best < t_unc * (1 - 1e-9) and (t_unc - cached_best) / t_unc >= threshold:
        return WorkloadClass.REUSE_SENSITIVE
    return WorkloadClass.THROUGHPUT_SENSITIVE


def op_table(ops: list[OpSpec]) -> list[dict]:
    """Characterization rows (Fig 4/5 analogue): intensity + demand per op."""
    rows = []
    for op in ops:
        unique = op.unique_bytes()
        stream = sum(o.hbm_bytes(p) for o, p in
                     zip(op.operands, [static_assignment(op, StaticMode.UNCACHED)[o.name]
                                       for o in op.operands]))
        rows.append({
            "name": op.name or op.kind,
            "kind": op.kind,
            "flops": op.flops,
            "unique_bytes": unique,
            "stream_bytes": stream,
            "arith_intensity_cached": op.arithmetic_intensity(),
            "arith_intensity_stream": op.flops / max(stream, 1),
        })
    return rows
