"""Row-locality-aware rinsing (§VII.B) adapted to HBM write-burst contiguity.

A copy of ``repro.core.rinse`` (host-side Python and numpy), line for
line: the port keeps its own so it never imports the JAX package, and
its plans and modeled costs equal the reference's with ``==``.

The paper attaches a *dirty-block index* to the GPU L2: evicting one dirty
block triggers writeback of every dirty block in the same DRAM row, so
writebacks arrive at the memory controller as row-local bursts.

On TPU the analogue is twofold:

1. **Static** (`plan_grid_order`): pick the kernel grid iteration order so
   output tiles are written in address order — coalesced writebacks sweep
   HBM contiguously instead of scattering across rows.
2. **Dynamic** (`DirtyIndex`): for software-managed dirty state that *is*
   flushed on events (KV-cache pages, gradient-accumulation buckets), keep a
   dirty index per contiguous HBM region and flush whole regions together.
   `repro.train` uses this to schedule bucketed ("rinsed") gradient
   reductions.
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict

from repro_torch import hw
from repro_torch.core.policy import Assignment, OpSpec, Policy


# ---------------------------------------------------------------------------
# Static: grid-order planning for kernels
# ---------------------------------------------------------------------------

def plan_grid_order(
    op: OpSpec,
    assignment: Assignment,
    chip: hw.Chip = hw.V5E,
    rinse: bool = True,
) -> tuple[tuple[str, ...], float]:
    """Loop-nest order (innermost last) + estimated write contiguity."""
    if op.kind in ("matmul", "conv2d"):
        out = op.outputs[0]
        accum = assignment[out.name] is Policy.RESIDENT_ACCUM
        if accum:
            # k innermost: each (m, n) tile written exactly once, and with
            # rinse the (m, n) sweep is row-major => address-ordered bursts.
            order = ("m", "n", "k") if rinse else ("n", "m", "k")
        else:
            # Write-through partials: k outermost revisits the whole output
            # per k step — inherently scattered revisits.
            order = ("k", "m", "n")
        contig = _matmul_contiguity(op, order, rinse, chip)
        return order, contig
    if op.kind == "attention":
        return ("batch_head", "q", "kv"), 0.98 if rinse else 0.8
    return ("e",), 1.0


def _matmul_contiguity(
    op: OpSpec, order: tuple[str, ...], rinse: bool, chip: hw.Chip
) -> float:
    n = op.meta.get("n", 1)
    bn = op.meta.get("bn", n)
    eb = hw.dtype_bytes(op.outputs[0].dtype)
    run = min(bn, n) * eb  # contiguous run per tile row
    base = min(1.0, run / chip.hbm_burst_bytes)
    if order[0] == "k":      # revisiting partial writes
        base *= 0.6
    if order[0] == "n":      # column-major tile sweep: rows interleave
        base *= 0.7
    if rinse:
        base = max(base, 0.95)
    return base


# ---------------------------------------------------------------------------
# Dynamic: dirty-region index for event-driven flushes
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Extent:
    addr: int
    size: int

    @property
    def end(self) -> int:
        return self.addr + self.size


class DirtyIndex:
    """Dirty-block index over contiguous HBM regions (paper's DBI [58])."""

    def __init__(self, region_bytes: int = 4096):
        assert region_bytes > 0
        self.region_bytes = region_bytes
        self._dirty: dict[int, dict[int, Extent]] = defaultdict(dict)
        self._tile_region: dict[int, int] = {}

    def _region(self, addr: int) -> int:
        return addr // self.region_bytes

    def mark(self, tile_id: int, addr: int, size: int) -> None:
        """Record tile_id as dirty over [addr, addr+size)."""
        r = self._region(addr)
        self._dirty[r][tile_id] = Extent(addr, size)
        self._tile_region[tile_id] = r

    @property
    def dirty_tiles(self) -> int:
        return sum(len(v) for v in self._dirty.values())

    def evict(self, tile_id: int, rinse: bool = True) -> list[tuple[int, Extent]]:
        """Flush list triggered by evicting ``tile_id``.

        With rinsing, every dirty tile in the same region flushes together
        (address-sorted); without, only the evicted tile flushes.
        """
        if tile_id not in self._tile_region:
            return []
        r = self._tile_region[tile_id]
        if rinse:
            victims = sorted(self._dirty[r].items(), key=lambda kv: kv[1].addr)
            for tid, _ in victims:
                del self._tile_region[tid]
            del self._dirty[r]
            return victims
        ext = self._dirty[r].pop(tile_id)
        del self._tile_region[tile_id]
        if not self._dirty[r]:
            del self._dirty[r]
        return [(tile_id, ext)]

    def flush_all(self, rinse: bool = True) -> list[tuple[int, Extent]]:
        out: list[tuple[int, Extent]] = []
        regions = sorted(self._dirty) if rinse else list(self._dirty)
        for r in regions:
            items = self._dirty[r].items()
            items = sorted(items, key=lambda kv: kv[1].addr) if rinse else list(items)
            out.extend(items)
        self._dirty.clear()
        self._tile_region.clear()
        return out


def write_contiguity(
    flushes: list[Extent], burst_bytes: int = hw.V5E.hbm_burst_bytes
) -> float:
    """Fraction of flushed bytes that land in contiguous runs >= one burst.

    Evaluates the *sequence* (not the set) of writes: only back-to-back
    address-adjacent extents merge into a run.
    """
    if not flushes:
        return 1.0
    total = 0
    covered = 0
    run = 0
    prev_end: int | None = None
    for e in flushes:
        total += e.size
        if prev_end is not None and e.addr == prev_end:
            run += e.size
        else:
            covered += (run // burst_bytes) * burst_bytes
            run = e.size
        prev_end = e.end
    covered += (run // burst_bytes) * burst_bytes
    return covered / total if total else 1.0


def bucket_flush_schedule(
    sizes: list[int], bucket_bytes: int
) -> list[list[int]]:
    """Group gradient tensors (by index) into contiguous flush buckets.

    The distributed-training use of rinsing: instead of one collective per
    tensor (scattered small flushes) or one giant end-of-step flush (no
    overlap), dirty tensors flush in contiguous, size-bounded buckets.
    """
    buckets: list[list[int]] = []
    cur: list[int] = []
    acc = 0
    for i, s in enumerate(sizes):
        if cur and acc + s > bucket_bytes:
            buckets.append(cur)
            cur, acc = [], 0
        cur.append(i)
        acc += s
    if cur:
        buckets.append(cur)
    return buckets
