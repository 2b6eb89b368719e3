"""Memoized policy planning — the PlanCache and Planner (DESIGN.md §3).

A copy of ``repro.core.planner`` (host-side Python and numpy), line for
line: the port keeps its own so it never imports the JAX package, and
its plans and modeled costs equal the reference's with ``==``.

Policy planning (characterize -> predict -> allocate -> cost) is pure: the
same op under the same (assignment, chip, calibration, AB, rinse) knobs
always produces the same :class:`KernelPlan` and :class:`CostBreakdown`.
The paper's workloads launch the *same* kernel hundreds of times (the RNN
suites re-launch one cell kernel 150-363x; a transformer plans one layer's
ops n_layers times), so the planner memoizes on a structural fingerprint of
the op rather than object identity.

Cache-key scheme (DESIGN.md §3):

    (namespace, fingerprint(op), assignment, chip, calib, ab, rinse)

(chip and calib are interned by *content* — dataclasses.astuple — so two
same-named chips with different parameters never alias entries)

* ``fingerprint(op)`` — SiteKey-style structural hash of the OpSpec: kind,
  dtype, flops and the full per-operand access profile (role, bytes,
  reuse window, contiguity, revisits) plus the scalar ``meta`` entries that
  feed the allocator's default blocks and the cost model's achieved
  efficiency.  The op's *name* is deliberately excluded: FwBwLSTM's dgrad
  op fingerprints identically to its forward op and shares one plan.
* costs are cached launch-free; launch overhead is re-applied on retrieval
  (it is the only term that varies with launch count).

Hit/miss counters feed the benchmark JSON (``plan_cache_hit_rate``).
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Callable

from repro_torch import hw
from repro_torch.core import allocator, cost_model
from repro_torch.core.policy import (
    Assignment,
    KernelPlan,
    OpSpec,
    Policy,
    StaticMode,
    static_assignment,
)


# Fingerprints are interned to small ints (`fingerprint_id`) so hot cache
# keys hash a couple of machine words instead of a large nested tuple on
# every lookup.  The interned id is stashed on the OpSpec itself (a frozen
# dataclass is still a plain object underneath; `dataclasses.replace`
# copies drop the stash and re-fingerprint, so staleness is impossible as
# long as nothing mutates operand profiles in place).
_FP_IDS: dict[tuple, int] = {}
_FID_ATTR = "_planner_fid"


def fingerprint_op(op: OpSpec) -> tuple:
    """Structural, hashable identity of an op for plan/cost memoization."""
    return _fingerprint_op(op)


def fingerprint_id(op: OpSpec) -> int:
    """Small interned equivalent of :func:`fingerprint_op` (equal
    fingerprints map to the same id, across distinct OpSpec objects)."""
    fid = op.__dict__.get(_FID_ATTR)
    if fid is not None:
        return fid
    fp = _fingerprint_op(op)
    fid = _FP_IDS.get(fp)
    if fid is None:
        fid = len(_FP_IDS)
        _FP_IDS[fp] = fid
    object.__setattr__(op, _FID_ATTR, fid)
    return fid


def _fingerprint_op(op: OpSpec) -> tuple:
    meta = tuple(sorted(
        (k, v) for k, v in op.meta.items()
        if isinstance(v, (int, float, str, bool))
    ))
    operands = tuple(
        (o.name, o.role, o.dtype, o.shape, o.unique_bytes,
         o.touched_bytes_stream, o.contiguity, o.revisits,
         o.reuse_window_bytes)
        for o in op.operands
    )
    return (op.kind, op.dtype, op.flops, operands, meta)


def assignment_key(op: OpSpec, assignment: Assignment) -> tuple:
    """Canonical (operand-ordered) encoding of a policy assignment."""
    return tuple(assignment[o.name].value for o in op.operands)


def calib_key(calib: cost_model.CostCalib) -> tuple:
    return dataclasses.astuple(calib)


_CALIB_IDS: dict[tuple, int] = {}


def _calib_id(calib: cost_model.CostCalib) -> int:
    k = calib_key(calib)
    cid = _CALIB_IDS.get(k)
    if cid is None:
        cid = len(_CALIB_IDS)
        _CALIB_IDS[k] = cid
    return cid


_CHIP_IDS: dict[tuple, int] = {}


def _chip_id(chip: hw.Chip) -> int:
    """Interned content id: two chips with equal parameters share an id,
    while same-named chips with different parameters do NOT alias cache
    entries (hw.Chip fields all default, so names collide easily)."""
    k = dataclasses.astuple(chip)
    cid = _CHIP_IDS.get(k)
    if cid is None:
        cid = len(_CHIP_IDS)
        _CHIP_IDS[k] = cid
    return cid


_MISSING = object()


class PlanCache:
    """Bounded LRU memo for plans, costs and lattice optima, with counters."""

    def __init__(self, max_entries: int = 1 << 16):
        self.max_entries = max_entries
        self._d: OrderedDict = OrderedDict()
        self.hits = 0
        self.misses = 0

    def lookup(self, key):
        """Fast-path probe: the cached value, or the ``_MISSING`` sentinel."""
        val = self._d.get(key, _MISSING)
        if val is not _MISSING:
            self.hits += 1
            self._d.move_to_end(key)
        return val

    def store(self, key, val):
        self.misses += 1
        self._d[key] = val
        if len(self._d) > self.max_entries:
            self._d.popitem(last=False)
        return val

    def get_or_compute(self, key, fn: Callable):
        val = self.lookup(key)
        if val is _MISSING:
            val = self.store(key, fn())
        return val

    @property
    def hit_rate(self) -> float:
        n = self.hits + self.misses
        return self.hits / n if n else 0.0

    def stats(self) -> dict:
        return {
            "hits": self.hits,
            "misses": self.misses,
            "entries": len(self._d),
            "hit_rate": self.hit_rate,
        }

    def clear(self) -> None:
        self._d.clear()
        self.hits = 0
        self.misses = 0

    def __len__(self) -> int:
        return len(self._d)


# Shared process-wide cache: the sweep/benchmark/engine default.  Safe
# because entries are immutable-by-convention (retrieval returns copies).
DEFAULT_CACHE = PlanCache()


def _copy_plan(plan: KernelPlan) -> KernelPlan:
    return dataclasses.replace(
        plan, assignment=dict(plan.assignment), block=dict(plan.block)
    )


def _apply_launches(
    bd: cost_model.CostBreakdown, launches: int, calib: cost_model.CostCalib
) -> cost_model.CostBreakdown:
    """Re-apply launch overhead to a launch-free cached breakdown.

    Reconstructs t_overhead/t_total with the same expression shape as
    ``op_cost`` so cached results are bit-identical to cold ones.
    """
    out = dataclasses.replace(bd)
    out.launches = launches
    out.t_overhead = bd.stall_frac * bd.t_hbm + launches * calib.launch_overhead_s
    out.t_total = max(bd.t_compute, bd.t_hbm) + out.t_overhead
    return out


class Planner:
    """Memoized planning facade over allocator/cost_model/sweep."""

    def __init__(
        self,
        chip: hw.Chip = hw.V5E,
        calib: cost_model.CostCalib = cost_model.CALIB,
        cache: PlanCache | None = None,
        table=None,
    ):
        self.chip = chip
        self.calib = calib
        self.cache = DEFAULT_CACHE if cache is None else cache
        self._ck = _calib_id(calib)
        self._chipk = _chip_id(chip)
        # Shared vectorized lattice store (core.sweep.SweepTable); created
        # lazily on the first exact search if not provided.
        self._table = table

    # -- memoized primitives ------------------------------------------------

    def plan(
        self,
        op: OpSpec,
        assignment: Assignment,
        allocation_bypass: bool = True,
        rinse: bool = True,
    ) -> KernelPlan:
        key = ("plan", fingerprint_id(op), assignment_key(op, assignment),
               self._chipk, self._ck, allocation_bypass, rinse)
        plan = self.cache.get_or_compute(
            key,
            lambda: allocator.plan_op(
                op, assignment, chip=self.chip,
                allocation_bypass=allocation_bypass, rinse=rinse,
            ),
        )
        return _copy_plan(plan)

    def cost(
        self,
        op: OpSpec,
        assignment: Assignment | None = None,
        mode: StaticMode | None = None,
        allocation_bypass: bool = True,
        rinse: bool = True,
        launches: int = 1,
    ) -> cost_model.CostBreakdown:
        if assignment is None:
            assignment = static_assignment(op, mode or StaticMode.UNCACHED)
        key = ("cost", fingerprint_id(op), assignment_key(op, assignment),
               self._chipk, self._ck, allocation_bypass, rinse)
        bd = self.cache.get_or_compute(
            key,
            lambda: cost_model.op_cost(
                op, assignment=assignment, chip=self.chip,
                allocation_bypass=allocation_bypass, rinse=rinse,
                launches=0, calib=self.calib,
            ),
        )
        return _apply_launches(bd, launches, self.calib)

    def launch_plan(
        self,
        op: OpSpec,
        allocation_bypass: bool = True,
        rinse: bool = True,
    ) -> tuple[KernelPlan, cost_model.CostBreakdown]:
        """One-stop per-launch query: adaptive plan + its one-launch cost.

        This is the hot serve-time path (one query per kernel launch), so
        the returned objects are the *shared cached instances* — treat them
        as read-only.  Use :meth:`plan`/:meth:`cost` when a private copy is
        needed.
        """
        key = ("launch", fingerprint_id(op), self._chipk, self._ck,
               allocation_bypass, rinse)
        val = self.cache.lookup(key)
        if val is not _MISSING:
            return val
        plan = allocator.plan_op(
            op,
            self.optimal_assignment(
                op, allocation_bypass=allocation_bypass, rinse=rinse
            ),
            chip=self.chip,
            allocation_bypass=allocation_bypass, rinse=rinse,
        )
        bd = cost_model.op_cost(
            op, assignment=plan.assignment, chip=self.chip,
            allocation_bypass=allocation_bypass, rinse=rinse,
            launches=1, calib=self.calib,
        )
        return self.cache.store(key, (plan, bd))

    def optimal_assignment(
        self,
        op: OpSpec,
        allocation_bypass: bool = True,
        rinse: bool = True,
    ) -> Assignment:
        """Exact lattice-optimal assignment (memoized; see core.sweep)."""
        from repro_torch.core import sweep  # local: sweep depends on cost_model

        if self._table is None:
            self._table = sweep.SweepTable(chip=self.chip, calib=self.calib)
        key = ("opt", fingerprint_id(op), self._chipk, self._ck,
               allocation_bypass, rinse)
        a = self.cache.get_or_compute(
            key,
            lambda: sweep.optimal_assignment(
                op, chip=self.chip, calib=self.calib,
                allocation_bypass=allocation_bypass, rinse=rinse,
                table=self._table,
            ),
        )
        return dict(a)

    def stats(self) -> dict:
        return self.cache.stats()
