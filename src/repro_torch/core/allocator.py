"""Non-blocking VMEM budget planner — the Allocation-Bypass analogue (§VII.A).

A copy of ``repro.core.allocator`` (host-side Python and numpy), line for
line: the port keeps its own so it never imports the JAX package, and
its plans and modeled costs equal the reference's with ``==``.

Turns a policy assignment into concrete MXU-aligned block shapes whose total
VMEM claim (double-buffered stream tiles + pinned resident operands + output
accumulators) fits the chip's VMEM budget.

The paper's insight, transplanted: when allocation would "block" (here: the
resident set over-subscribes VMEM), **do not stall** — demote the
least-valuable resident operand to STREAM (a bypass request) instead of
squeezing compute tiles below MXU-efficient sizes.  With
``allocation_bypass=False`` (the paper's blocking baseline) the planner keeps
residency and shrinks compute tiles instead; every halving is recorded as a
shrink event (the cache-stall proxy reported by the Fig 8/12 benchmarks).
"""
from __future__ import annotations

import dataclasses

from repro_torch import hw
from repro_torch.core import rinse as rinse_mod
from repro_torch.core.policy import (
    Assignment,
    KernelPlan,
    OpSpec,
    Policy,
    reuse_density,
)

MIN_BLOCK = 128          # MXU-aligned floor; shrinking below this is a "stall"
HARD_MIN_BLOCK = 8       # absolute floor (vector sublane)


@dataclasses.dataclass
class _Claim:
    name: str
    bytes_fn: object        # callable(block: dict[str,int]) -> int
    demotable: bool
    density: float          # reuse traffic saved per byte claimed


def _align_down(x: int, align: int) -> int:
    if x <= align:
        return x
    return (x // align) * align


def _default_blocks(op: OpSpec) -> dict[str, int]:
    m = op.meta
    if op.kind in ("matmul", "conv2d"):
        return {
            "bm": min(512, m["m"]),
            "bn": min(512, m["n"]),
            "bk": min(512, m["k"]),
        }
    if op.kind == "attention":
        return {"bq": min(512, m["sq"]), "bkv": min(512, m["skv"])}
    if op.kind in ("elementwise", "rowwise", "window"):
        elems = m.get("elems", m.get("rows", 1) * m.get("row_len", 1))
        return {"be": min(elems, 512 * 1024)}
    return {"be": 512 * 1024}


def _vmem_claim(
    op: OpSpec,
    assignment: Assignment,
    block: dict[str, int],
    elem_accum_dtype_bytes: int = 4,
) -> tuple[int, dict[str, int]]:
    """Total VMEM bytes claimed, and the per-operand claims."""
    eb = hw.dtype_bytes(op.dtype)
    per: dict[str, int] = {}
    kind = op.kind
    if kind in ("matmul", "conv2d"):
        tiles = {
            "a": block["bm"] * block["bk"],
            "b": block["bk"] * block["bn"],
            "out": block["bm"] * block["bn"],
        }
        default_tile = block["bm"] * block["bn"]
    elif kind == "attention":
        d = op.meta["head_dim"]
        tiles = {
            "q": block["bq"] * d,
            "k": block["bkv"] * d,
            "v": block["bkv"] * d,
            "out": block["bq"] * d,
        }
        default_tile = None
    else:
        tiles = {}
        default_tile = block["be"]
    for o in op.operands:
        pol = assignment[o.name]
        tile_elems = tiles.get(o.name, default_tile)
        tile_elems = min(tile_elems, max(1, o.unique_bytes // eb))
        if o.is_output:
            if pol is Policy.RESIDENT_ACCUM:
                per[o.name] = tile_elems * elem_accum_dtype_bytes
            else:
                per[o.name] = 2 * tile_elems * eb
        elif pol is Policy.RESIDENT:
            per[o.name] = o.window_bytes
        else:
            per[o.name] = 2 * tile_elems * eb
    return sum(per.values()), per


def plan_op(
    op: OpSpec,
    assignment: Assignment,
    chip: hw.Chip = hw.V5E,
    allocation_bypass: bool = True,
    rinse: bool = True,
) -> KernelPlan:
    """Produce a VMEM-feasible KernelPlan for ``op`` under ``assignment``."""
    assignment = dict(assignment)
    block = _default_blocks(op)
    budget = chip.vmem_budget
    demotions: list[str] = []
    shrink_events = 0
    density = reuse_density
    while True:
        claim, per = _vmem_claim(op, assignment, block)
        if claim <= budget:
            break
        # Allocation bypass: demote the least reuse-dense resident — but
        # only when demotion actually shrinks the claim (its window costs
        # more than the stream double-buffer it would get instead).
        residents = [
            o for o in op.inputs
            if assignment[o.name] is Policy.RESIDENT
        ]
        if allocation_bypass and residents:
            trial = dict(assignment)
            victim = min(residents, key=density)
            trial[victim.name] = Policy.STREAM
            new_claim, _ = _vmem_claim(op, trial, block)
            if new_claim < claim:
                assignment = trial
                demotions.append(victim.name)
                continue
        # Blocking baseline (or nothing left to demote): shrink the largest
        # block dim.  Below MIN_BLOCK this is MXU-starving — a stall.
        dim = max(block, key=lambda d: block[d])
        if block[dim] <= HARD_MIN_BLOCK:
            # Physically infeasible residency: forced demotion even in the
            # blocking baseline (a GPU would thrash; we record max stalls).
            if residents:
                victim = min(residents, key=density)
                assignment[victim.name] = Policy.STREAM
                demotions.append(victim.name)
                shrink_events += 4
                continue
            break
        new = _align_down(block[dim] // 2, MIN_BLOCK) if block[dim] > MIN_BLOCK else block[dim] // 2
        block[dim] = max(new, HARD_MIN_BLOCK)
        shrink_events += 1

    order, contiguity = rinse_mod.plan_grid_order(op, assignment, chip, rinse=rinse)
    claim, _ = _vmem_claim(op, assignment, block)
    return KernelPlan(
        op=op,
        assignment=assignment,
        block=block,
        grid_order=order,
        vmem_bytes=claim,
        demotions=tuple(demotions),
        shrink_events=shrink_events,
        rinse=rinse,
        notes=f"write_contiguity≈{contiguity:.2f}",
    )


def mxu_efficiency(plan: KernelPlan, chip: hw.Chip = hw.V5E) -> float:
    """Compute-efficiency factor implied by the plan's block shapes."""
    if plan.op.kind in ("matmul", "conv2d"):
        dims = ("bm", "bn", "bk")
    elif plan.op.kind == "attention":
        dims = ("bq", "bkv")
    else:
        return 1.0
    eff = 1.0
    for d in dims:
        eff *= min(1.0, plan.block[d] / chip.mxu_dim)
    return max(eff, 1e-3)
