"""Roofline cost model with caching-overhead terms (paper §VI.C).

A copy of ``repro.core.cost_model`` (host-side Python and numpy), line for
line: the port keeps its own so it never imports the JAX package, and
its plans and modeled costs equal the reference's with ``==``.

Models the execution time of one op under a policy assignment as

    t_total = max(t_compute, t_hbm) + t_overhead

where the overhead term carries the paper's two caching costs, adapted to a
software-managed hierarchy (DESIGN.md §2):

* **stalls** — on the GPU these are blocked cache allocations; here they are
  the contention charged when an operand is held RESIDENT but its reuse
  window exceeds the residency budget (thrash regime).  Allocation-Bypass
  (``allocation_bypass=True``) eliminates the stall term, exactly as the
  paper's AB converts blocking allocations into bypasses.
* **write-locality disruption** — DRAM row-hit loss becomes an HBM
  write-burst *contiguity* derate.  Coalesced (RESIDENT_ACCUM) writebacks
  scatter unless the rinse scheduler orders them; rinsing restores
  contiguity, exactly as the paper's CR restores row hits.

Calibration constants live in :data:`CALIB`; magnitudes are matched to the
paper's reported ranges (caching hurts throughput-sensitive workloads by up
to ~24%, write coalescing wins up to ~32%).
"""
from __future__ import annotations

import dataclasses

from repro_torch import hw
from repro_torch.core.policy import (
    Assignment,
    OperandProfile,
    OpSpec,
    Policy,
    StaticMode,
    reuse_density,
    static_assignment,
)


@dataclasses.dataclass(frozen=True)
class CostCalib:
    # Fraction of peak FLOP/s a well-tiled kernel achieves (MXU/SIMD realism).
    achieved_compute_frac: float = 0.6
    # Max fraction of HBM time added by allocation-blocking stalls (paper: the
    # throughput-sensitive degradations top out ~24%).
    max_stall_frac: float = 0.12
    # Write contiguity of delayed/coalesced writebacks without rinsing.
    coalesce_contiguity: float = 0.7
    # ... and with row-locality-aware rinsing (paper Fig 13: CR beats best static).
    rinse_contiguity: float = 0.98
    # Effective-bandwidth floor for fully scattered writes (burst efficiency).
    burst_floor: float = 0.35
    # Fixed kernel-launch cost (dispatch + DMA warmup).
    launch_overhead_s: float = 2e-6
    # Default streaming tile (double-buffered) for VMEM claims.
    stream_tile_bytes: int = 2 * 1024 * 1024
    # Residency accumulator claim cap (fp32 output tile).
    accum_tile_bytes: int = 512 * 1024
    # AB demotes (reports) resident operands realizing less than this fraction.
    demote_threshold: float = 0.5


CALIB = CostCalib()


@dataclasses.dataclass
class ResidencyPlan:
    """How much of each RESIDENT operand's reuse window actually fits."""

    realized: dict[str, float]
    vmem_claimed: int
    demotions: tuple[str, ...]


@dataclasses.dataclass
class CostBreakdown:
    t_compute: float = 0.0
    t_hbm: float = 0.0
    t_overhead: float = 0.0
    t_total: float = 0.0
    read_bytes: float = 0.0
    write_bytes: float = 0.0
    write_contiguity: float = 1.0
    stall_frac: float = 0.0
    launches: int = 0
    demotions: int = 0
    vmem_claimed: int = 0

    @property
    def hbm_bytes(self) -> float:
        return self.read_bytes + self.write_bytes

    def add(self, other: "CostBreakdown") -> "CostBreakdown":
        w = self.write_bytes + other.write_bytes
        self.write_contiguity = (
            (self.write_contiguity * self.write_bytes
             + other.write_contiguity * other.write_bytes) / w
            if w else 1.0
        )
        self.t_compute += other.t_compute
        self.t_hbm += other.t_hbm
        self.t_overhead += other.t_overhead
        self.t_total += other.t_total
        self.read_bytes += other.read_bytes
        self.write_bytes += other.write_bytes
        self.stall_frac = max(self.stall_frac, other.stall_frac)
        self.launches += other.launches
        self.demotions += other.demotions
        self.vmem_claimed = max(self.vmem_claimed, other.vmem_claimed)
        return self


def _peak_flops(chip: hw.Chip, dtype: str) -> float:
    nbytes = hw.dtype_bytes(dtype)
    if nbytes <= 2:
        return chip.peak_flops_bf16
    if nbytes == 4:
        return chip.peak_flops_fp32
    return chip.peak_flops_fp32 / 2  # fp64


def _stream_tile(chip: hw.Chip, calib: CostCalib) -> int:
    """Streaming double-buffer tile, scaled to the chip's residency budget."""
    return min(calib.stream_tile_bytes, chip.vmem_budget // 8)


def plan_residency(
    op: OpSpec,
    assignment: Assignment,
    chip: hw.Chip,
    calib: CostCalib = CALIB,
) -> ResidencyPlan:
    """Greedy residency-budget allocation (reuse-densest operands first)."""
    budget = chip.vmem_budget
    tile = _stream_tile(chip, calib)
    # Reserve double-buffers for every streamed input and accumulators for
    # coalesced outputs first — these are mandatory.
    for o in op.operands:
        pol = assignment[o.name]
        if o.is_output:
            if pol is Policy.RESIDENT_ACCUM:
                budget -= min(o.unique_bytes * 2, calib.accum_tile_bytes)
            else:
                budget -= min(o.unique_bytes, tile)
        elif pol is Policy.STREAM:
            budget -= 2 * min(o.unique_bytes, tile)
    budget = max(budget, 0)

    resident = [o for o in op.inputs if assignment[o.name] is Policy.RESIDENT]
    realized: dict[str, float] = {}
    claimed = chip.vmem_budget - budget
    for o in sorted(resident, key=reuse_density, reverse=True):
        take = min(o.window_bytes, budget)
        realized[o.name] = take / max(o.window_bytes, 1)
        budget -= take
        claimed += take
    demotions = tuple(
        name for name, frac in realized.items() if frac < calib.demote_threshold
    )
    return ResidencyPlan(realized=realized, vmem_claimed=claimed, demotions=demotions)


def op_cost(
    op: OpSpec,
    assignment: Assignment | None = None,
    mode: StaticMode | None = None,
    chip: hw.Chip = hw.V5E,
    allocation_bypass: bool = True,
    rinse: bool = True,
    launches: int = 1,
    calib: CostCalib = CALIB,
) -> CostBreakdown:
    """Model one op's execution time under a policy assignment."""
    if assignment is None:
        assignment = static_assignment(op, mode or StaticMode.UNCACHED)
    res = plan_residency(op, assignment, chip, calib)

    read_bytes = 0.0
    stall = 0.0
    for o in op.inputs:
        pol = assignment[o.name]
        if pol is Policy.RESIDENT:
            frac = res.realized.get(o.name, 0.0)
            # Partial residency: reuse captured proportionally to the window
            # fraction that fits (cache-thrash regime when frac << 1).
            traffic = o.touched_bytes_stream - (
                (o.touched_bytes_stream - o.unique_bytes) * frac
            )
            if frac < 1.0 and not allocation_bypass:
                stall = max(stall, calib.max_stall_frac * (1.0 - frac))
        else:
            traffic = float(o.touched_bytes_stream)
        read_bytes += traffic

    write_bytes = 0.0
    contig_acc = 0.0
    for o in op.outputs:
        pol = assignment[o.name]
        traffic = float(o.hbm_bytes(pol))
        if pol is Policy.RESIDENT_ACCUM:
            c = max(calib.rinse_contiguity, o.contiguity) if rinse else (
                o.contiguity * calib.coalesce_contiguity
            )
            if traffic > o.unique_bytes:
                # Partial write-through still re-reads partials.
                read_bytes += traffic - o.unique_bytes
                traffic = float(o.unique_bytes)
        else:
            c = o.contiguity * (1.0 - stall)
        write_bytes += traffic
        contig_acc += c * traffic
    contiguity = contig_acc / write_bytes if write_bytes else 1.0

    eff = float(op.meta.get("achieved_eff", calib.achieved_compute_frac))
    t_compute = op.flops / (_peak_flops(chip, op.dtype) * max(eff, 1e-3))
    bw_eff = calib.burst_floor + (1.0 - calib.burst_floor) * contiguity
    t_hbm = read_bytes / chip.hbm_bw + write_bytes / (chip.hbm_bw * bw_eff)
    t_overhead = stall * t_hbm + launches * calib.launch_overhead_s
    return CostBreakdown(
        t_compute=t_compute,
        t_hbm=t_hbm,
        t_overhead=t_overhead,
        t_total=max(t_compute, t_hbm) + t_overhead,
        read_bytes=read_bytes,
        write_bytes=write_bytes,
        write_contiguity=contiguity,
        stall_frac=stall,
        launches=launches,
        demotions=len(res.demotions),
        vmem_claimed=res.vmem_claimed,
    )


def adaptive_assignment(
    op: OpSpec, chip: hw.Chip = hw.V5E, calib: CostCalib = CALIB
) -> Assignment:
    """Cost-model-seeded per-operand policy (the PCby criterion, §VII.C):
    cache exactly the accesses whose reuse is realizable and beneficial."""
    a: Assignment = {}
    tile = _stream_tile(chip, calib)
    budget = chip.vmem_budget
    for o in op.operands:
        if o.is_output:
            a[o.name] = Policy.RESIDENT_ACCUM if o.revisits > 1 else Policy.STREAM
            budget -= (
                min(o.unique_bytes * 2, calib.accum_tile_bytes)
                if o.revisits > 1 else min(o.unique_bytes, tile)
            )
        else:
            a[o.name] = Policy.STREAM
            budget -= 2 * min(o.unique_bytes, tile)
    # Residency candidates, densest first, greedily while they fit.  A
    # promoted operand trades its streaming double-buffer for its window.
    cands = [o for o in op.inputs if o.reuse_factor > 1.1]
    cands.sort(key=reuse_density, reverse=True)
    for o in cands:
        extra = o.window_bytes - 2 * min(o.unique_bytes, tile)
        if extra <= budget:
            a[o.name] = Policy.RESIDENT
            budget -= extra
    return a


def workload_cost(
    ops: list[OpSpec],
    mode: StaticMode = StaticMode.UNCACHED,
    chip: hw.Chip = hw.V5E,
    allocation_bypass: bool | None = None,
    rinse: bool | None = None,
    launches_per_op: int = 1,
    calib: CostCalib = CALIB,
    search: str = "exact",
    memoize: bool = True,
    plan_cache=None,
) -> CostBreakdown:
    """Sum of op costs under a static mode or the adaptive engine.

    Static modes default to the paper's *baseline* machine behaviour:
    blocking allocation, no rinse.  ADAPTIVE defaults to AB+CR+PCby on.

    ``search`` picks the adaptive-mode assignment: ``"exact"`` (lattice
    argmin via ``core.sweep``, never worse than greedy) or ``"greedy"``
    (the original ``adaptive_assignment`` walk).  ``memoize`` routes
    plan/cost evaluation through the :class:`~repro.core.planner.PlanCache`
    (``plan_cache``, or the shared default) — cached results are
    bit-identical to cold ones, so this only changes wall time.
    """
    adaptive = mode is StaticMode.ADAPTIVE
    ab = adaptive if allocation_bypass is None else allocation_bypass
    rn = adaptive if rinse is None else rinse
    planner = None
    if memoize or (adaptive and search == "exact"):
        from repro_torch.core.planner import Planner  # local: avoid import cycle

        planner = Planner(chip=chip, calib=calib, cache=plan_cache)
    total = CostBreakdown()
    for op in ops:
        if adaptive:
            if search == "exact":
                assignment = planner.optimal_assignment(
                    op, allocation_bypass=ab, rinse=rn
                )
            else:
                assignment = adaptive_assignment(op, chip, calib)
        else:
            assignment = static_assignment(op, mode)
        if memoize:
            bd = planner.cost(
                op, assignment=assignment, allocation_bypass=ab, rinse=rn,
                launches=launches_per_op,
            )
        else:
            bd = op_cost(
                op,
                assignment=assignment,
                chip=chip,
                allocation_bypass=ab,
                rinse=rn,
                launches=launches_per_op,
                calib=calib,
            )
        total.add(bd)
    return total
