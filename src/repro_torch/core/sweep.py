"""Vectorized policy-lattice sweep (DESIGN.md §3).

A copy of ``repro.core.sweep`` (host-side Python and numpy), line for
line: the port keeps its own so it never imports the JAX package, and
its plans and modeled costs equal the reference's with ``==``.

Evaluates the *entire* per-operand policy lattice for a batch of ops in a
handful of NumPy array operations, instead of one pure-Python
characterize -> plan_residency -> op_cost walk per (op, assignment) query.

The lattice for one op is

    {STREAM, RESIDENT}^inputs x {STREAM, RESIDENT_ACCUM}^outputs
        x {AB off/on} x {rinse off/on}

— every static mode, every greedy/adaptive choice and every ablation the
benchmarks query is one row of it.  The math mirrors
:func:`repro.core.cost_model.op_cost` + ``plan_residency`` term for term
(the only differences are float summation order, ~1 ulp); correctness is
pinned by tests comparing against the scalar reference.

``optimal_assignment`` replaces the greedy ``adaptive_assignment`` with an
exact argmin over the lattice.  The returned assignment is re-scored with
the *scalar* cost model against the greedy assignment, so the invariant

    t_total(exact) <= t_total(greedy)

holds exactly, ulps included, and ties keep the greedy choice (stable
seeding for the PCby predictor).  Ops wider than ``max_exact_operands``
inputs fall back to greedy (the lattice is 2^n).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch import hw
from repro_torch.core import cost_model
from repro_torch.core.characterize import OpTensors, operand_tensors
from repro_torch.core.cost_model import CALIB, CostCalib, _peak_flops, _stream_tile
from repro_torch.core.policy import (
    Assignment,
    OpSpec,
    Policy,
    StaticMode,
    static_assignment,
)

# Lattice width guards: 4 * 2^inputs * 2^outputs rows per op; beyond these
# bounds the exact search falls back to greedy and SweepTable serves
# queries from the scalar cost model instead.  The joint bound caps the
# row count (4 * 2^14 rows ~ a few MB of float64 per column), which the
# per-side bounds alone would not (12 inputs + 8 outputs -> 2^20 rows).
MAX_EXACT_INPUTS = 12
MAX_EXACT_OUTPUTS = 8
MAX_EXACT_LATTICE_BITS = 14


def exact_lattice_ok(op: OpSpec) -> bool:
    ni, no = len(op.inputs), len(op.outputs)
    return (ni <= MAX_EXACT_INPUTS and no <= MAX_EXACT_OUTPUTS
            and ni + no <= MAX_EXACT_LATTICE_BITS)

# (allocation_bypass, rinse) combo axis, folded into the row index.
COMBOS = ((False, False), (False, True), (True, False), (True, True))


def _combo_index(allocation_bypass: bool, rinse: bool) -> int:
    return (2 if allocation_bypass else 0) + (1 if rinse else 0)


@dataclasses.dataclass
class BatchSweep:
    """All policy-lattice costs for a batch of ops, as [n_ops, R] arrays.

    Row layout: ``r = (combo << (I_max + O_max)) | (in_bits << O_max) | out_bits``
    where input bit *j* marks the *j*-th density-ordered input RESIDENT and
    output bit *j* marks the *j*-th output RESIDENT_ACCUM.
    """

    ops: list[OpSpec]
    chip: hw.Chip
    calib: CostCalib
    tensors: list[OpTensors]
    imax: int
    omax: int
    t_compute: np.ndarray      # [n_ops]
    t_hbm: np.ndarray          # [n_ops, R]
    t_overhead0: np.ndarray    # [n_ops, R] launch-free (stall * t_hbm)
    t_total0: np.ndarray       # [n_ops, R] launch-free
    read_bytes: np.ndarray     # [n_ops, R]
    write_bytes: np.ndarray    # [n_ops, R]
    contiguity: np.ndarray     # [n_ops, R]
    stall: np.ndarray          # [n_ops, R]
    demotions: np.ndarray      # [n_ops, R] int
    vmem: np.ndarray           # [n_ops, R]
    valid: np.ndarray          # [n_ops, R] bool

    # -- row addressing -----------------------------------------------------

    def row(self, in_bits: int, out_bits: int,
            allocation_bypass: bool, rinse: bool) -> int:
        c = _combo_index(allocation_bypass, rinse)
        return (c << (self.imax + self.omax)) | (in_bits << self.omax) | out_bits

    def bits_of_assignment(self, op_i: int, a: Assignment) -> tuple[int, int]:
        t = self.tensors[op_i]
        in_bits = sum(
            1 << j for j, name in enumerate(t.in_names)
            if a[name] is Policy.RESIDENT
        )
        out_bits = sum(
            1 << j for j, name in enumerate(t.out_names)
            if a[name] is Policy.RESIDENT_ACCUM
        )
        return in_bits, out_bits

    def bits_of_mode(self, op_i: int, mode: StaticMode) -> tuple[int, int]:
        t = self.tensors[op_i]
        if mode is StaticMode.UNCACHED:
            return 0, 0
        if mode is StaticMode.CACHER:
            return (1 << t.n_inputs) - 1, 0
        if mode is StaticMode.CACHERW:
            return (1 << t.n_inputs) - 1, (1 << t.n_outputs) - 1
        raise ValueError("adaptive mode has no fixed lattice row; use best()")

    def assignment_at(self, op_i: int, in_bits: int, out_bits: int) -> Assignment:
        t = self.tensors[op_i]
        a: Assignment = {}
        for j, name in enumerate(t.in_names):
            a[name] = Policy.RESIDENT if (in_bits >> j) & 1 else Policy.STREAM
        for j, name in enumerate(t.out_names):
            a[name] = (
                Policy.RESIDENT_ACCUM if (out_bits >> j) & 1 else Policy.STREAM
            )
        return a

    # -- queries ------------------------------------------------------------

    def breakdown(
        self,
        op_i: int,
        mode: StaticMode | None = None,
        assignment: Assignment | None = None,
        allocation_bypass: bool = True,
        rinse: bool = True,
        launches: int = 1,
    ) -> cost_model.CostBreakdown:
        if assignment is not None:
            in_bits, out_bits = self.bits_of_assignment(op_i, assignment)
        else:
            in_bits, out_bits = self.bits_of_mode(
                op_i, mode or StaticMode.UNCACHED
            )
        r = self.row(in_bits, out_bits, allocation_bypass, rinse)
        return self.breakdown_at(op_i, r, launches)

    def breakdown_at(
        self, op_i: int, r: int, launches: int = 1
    ) -> cost_model.CostBreakdown:
        t_over = (
            self.t_overhead0[op_i, r]
            + launches * self.calib.launch_overhead_s
        )
        tc = self.t_compute[op_i]
        th = self.t_hbm[op_i, r]
        return cost_model.CostBreakdown(
            t_compute=float(tc),
            t_hbm=float(th),
            t_overhead=float(t_over),
            t_total=float(max(tc, th) + t_over),
            read_bytes=float(self.read_bytes[op_i, r]),
            write_bytes=float(self.write_bytes[op_i, r]),
            write_contiguity=float(self.contiguity[op_i, r]),
            stall_frac=float(self.stall[op_i, r]),
            launches=launches,
            demotions=int(self.demotions[op_i, r]),
            vmem_claimed=int(self.vmem[op_i, r]),
        )

    def best(
        self, op_i: int, allocation_bypass: bool = True, rinse: bool = True
    ) -> tuple[Assignment, float]:
        """Exact lattice argmin for one op under one (AB, rinse) combo."""
        c = _combo_index(allocation_bypass, rinse)
        width = 1 << (self.imax + self.omax)
        lo = c * width
        seg = np.where(
            self.valid[op_i, lo:lo + width],
            self.t_total0[op_i, lo:lo + width],
            np.inf,
        )
        r = int(np.argmin(seg))
        out_bits = r & ((1 << self.omax) - 1)
        in_bits = r >> self.omax
        return self.assignment_at(op_i, in_bits, out_bits), float(seg[r])


def sweep_ops(
    ops: list[OpSpec],
    chip: hw.Chip = hw.V5E,
    calib: CostCalib = CALIB,
) -> BatchSweep:
    """Evaluate the full policy lattice for a batch of ops, vectorized."""
    tensors = [operand_tensors(op) for op in ops]
    n = len(ops)
    imax = max((t.n_inputs for t in tensors), default=0)
    omax = max((t.n_outputs for t in tensors), default=0)
    if imax > MAX_EXACT_INPUTS:
        raise ValueError(
            f"op with {imax} inputs exceeds the exact-lattice bound "
            f"({MAX_EXACT_INPUTS}); use the greedy fallback"
        )
    if omax > MAX_EXACT_OUTPUTS or imax + omax > MAX_EXACT_LATTICE_BITS:
        raise ValueError(
            f"op lattice 2^({imax}+{omax}) exceeds the exact bounds "
            f"(<= {MAX_EXACT_INPUTS} inputs, <= {MAX_EXACT_OUTPUTS} outputs,"
            f" <= {MAX_EXACT_LATTICE_BITS} joint); use the greedy fallback"
        )
    R = 4 * (1 << imax) * (1 << omax)
    tile = _stream_tile(chip, calib)
    B = float(chip.vmem_budget)

    # Padded per-op operand arrays ([n, imax] / [n, omax]; padding is
    # zero-byte operands that drop out of every sum).
    in_u = np.zeros((n, imax)); in_t = np.zeros((n, imax))
    in_w = np.zeros((n, imax)); in_sbuf = np.zeros((n, imax))
    out_u = np.zeros((n, omax)); out_wt = np.zeros((n, omax))
    out_c = np.zeros((n, omax))
    claim_acc = np.zeros((n, omax)); claim_str = np.zeros((n, omax))
    t_compute = np.zeros(n)
    ni = np.array([t.n_inputs for t in tensors])
    no = np.array([t.n_outputs for t in tensors])
    for i, (op, t) in enumerate(zip(ops, tensors)):
        k, o = t.n_inputs, t.n_outputs
        in_u[i, :k] = t.in_unique
        in_t[i, :k] = t.in_touched
        in_w[i, :k] = t.in_window
        in_sbuf[i, :k] = 2 * np.minimum(t.in_unique, tile)
        out_u[i, :o] = t.out_unique
        out_wt[i, :o] = t.out_writethrough
        out_c[i, :o] = t.out_contiguity
        claim_acc[i, :o] = np.minimum(
            t.out_unique * 2, calib.accum_tile_bytes
        )
        claim_str[i, :o] = np.minimum(t.out_unique, tile)
        eff = (
            calib.achieved_compute_frac
            if t.achieved_eff is None else t.achieved_eff
        )
        t_compute[i] = t.flops / (_peak_flops(chip, op.dtype) * max(eff, 1e-3))

    # Row decode (shared across ops).
    r_all = np.arange(R)
    out_bits = r_all & ((1 << omax) - 1)
    in_bits = (r_all >> omax) & ((1 << imax) - 1)
    combo = r_all >> (imax + omax)
    ab_row = combo >= 2
    rinse_row = (combo & 1) == 1
    res = ((in_bits[:, None] >> np.arange(imax)[None, :]) & 1).astype(bool)
    acc = ((out_bits[:, None] >> np.arange(omax)[None, :]) & 1).astype(bool)
    valid = (
        (in_bits[None, :] < (1 << ni)[:, None])
        & (out_bits[None, :] < (1 << no)[:, None])
    )

    # --- residency planning (plan_residency, vectorized) -------------------
    # Mandatory claims: output accumulators/stream buffers + double buffers
    # for every STREAMed input; then greedy window allocation densest-first
    # (inputs are pre-sorted by density) via a masked cumulative sum.
    mand = (
        np.einsum("oj,rj->or", in_sbuf, ~res)
        + np.einsum("oj,rj->or", claim_str, ~acc)
        + np.einsum("oj,rj->or", claim_acc, acc)
    )
    budget0 = np.maximum(B - mand, 0.0)                       # [n, R]
    W = in_w[:, None, :] * res[None, :, :]                    # [n, R, I]
    prev = np.cumsum(W, axis=2) - W
    take = np.clip(budget0[:, :, None] - prev, 0.0, W)
    frac = take / np.maximum(in_w, 1.0)[:, None, :]
    vmem = np.minimum(mand, B) + take.sum(axis=2)
    demotions = (
        res[None, :, :] & (frac < calib.demote_threshold)
    ).sum(axis=2)

    # --- read traffic + allocation stalls ----------------------------------
    read_per = np.where(
        res[None, :, :],
        in_t[:, None, :] - (in_t - in_u)[:, None, :] * frac,
        in_t[:, None, :],
    )
    read = read_per.sum(axis=2)
    stall_per = np.where(
        res[None, :, :] & (frac < 1.0),
        calib.max_stall_frac * (1.0 - frac),
        0.0,
    )
    stall = stall_per.max(axis=2, initial=0.0)
    stall = np.where(ab_row[None, :], 0.0, stall)

    # --- write traffic + burst contiguity ----------------------------------
    traffic = np.where(acc[None, :, :], out_u[:, None, :], out_wt[:, None, :])
    c_acc = np.where(
        rinse_row[None, :, None],
        np.maximum(calib.rinse_contiguity, out_c[:, None, :]),
        out_c[:, None, :] * calib.coalesce_contiguity,
    )
    c_str = out_c[:, None, :] * (1.0 - stall[:, :, None])
    c_per = np.where(acc[None, :, :], c_acc, c_str)
    write = traffic.sum(axis=2)
    with np.errstate(invalid="ignore", divide="ignore"):
        contig = np.where(
            write > 0, (c_per * traffic).sum(axis=2) / write, 1.0
        )

    # --- roofline ----------------------------------------------------------
    bw_eff = calib.burst_floor + (1.0 - calib.burst_floor) * contig
    t_hbm = read / chip.hbm_bw + write / (chip.hbm_bw * bw_eff)
    t_over0 = stall * t_hbm
    t_total0 = np.maximum(t_compute[:, None], t_hbm) + t_over0

    return BatchSweep(
        ops=list(ops), chip=chip, calib=calib, tensors=tensors,
        imax=imax, omax=omax,
        t_compute=t_compute, t_hbm=t_hbm, t_overhead0=t_over0,
        t_total0=t_total0, read_bytes=read, write_bytes=write,
        contiguity=contig, stall=stall, demotions=demotions, vmem=vmem,
        valid=valid,
    )


def optimal_assignment(
    op: OpSpec,
    chip: hw.Chip = hw.V5E,
    calib: CostCalib = CALIB,
    allocation_bypass: bool = True,
    rinse: bool = True,
    max_exact_inputs: int = MAX_EXACT_INPUTS,
    table: "SweepTable | None" = None,
) -> Assignment:
    """Exact lattice-optimal per-operand assignment (greedy on ties/overflow).

    Guarantee: the returned assignment's scalar ``op_cost(...).t_total`` is
    <= the greedy ``adaptive_assignment``'s, because the lattice candidate
    is re-scored with the scalar model and greedy wins ties.

    Pass a shared ``table`` to reuse already-swept lattice rows instead of
    sweeping this op privately.
    """
    greedy = cost_model.adaptive_assignment(op, chip, calib)
    # The caller's bound can only tighten the hard module bounds (sweep_ops
    # enforces them regardless, so a looser bound would just crash there).
    if (len(op.inputs) > min(max_exact_inputs, MAX_EXACT_INPUTS)
            or not exact_lattice_ok(op)):
        return greedy
    if table is not None:
        cand = table.best_assignment(
            op, allocation_bypass=allocation_bypass, rinse=rinse
        )
    else:
        bs = sweep_ops([op], chip=chip, calib=calib)
        cand, _ = bs.best(0, allocation_bypass=allocation_bypass, rinse=rinse)

    def score(a: Assignment) -> float:
        return cost_model.op_cost(
            op, assignment=a, chip=chip,
            allocation_bypass=allocation_bypass, rinse=rinse,
            launches=0, calib=calib,
        ).t_total

    return cand if score(cand) < score(greedy) else greedy


class SweepTable:
    """Fingerprint-deduplicated sweep store serving workload/op queries.

    Ops are batched into :class:`BatchSweep` chunks on first sight; two ops
    with the same fingerprint (e.g. an RNN cell re-launched 150x, or a
    dgrad op shaped like its forward) share one set of lattice rows.
    """

    def __init__(self, chip: hw.Chip = hw.V5E, calib: CostCalib = CALIB):
        self.chip = chip
        self.calib = calib
        self._index: dict[int, tuple[BatchSweep, int]] = {}
        # Query-level memos (values are shared read-only instances).
        self._bd: dict[tuple, cost_model.CostBreakdown] = {}
        self._best: dict[tuple, Assignment] = {}
        self.hits = 0
        self.misses = 0

    def add(self, ops: list[OpSpec]) -> None:
        from repro_torch.core.planner import fingerprint_id

        # Bucket by operand width: batch arrays are padded to the widest
        # member, so co-batching a wide op with narrow ones would make
        # every row table pay the wide op's 2^n lattice.
        buckets: dict[tuple[int, int], tuple[list[OpSpec], list[int]]] = {}
        seen = set(self._index)
        for op in ops:
            if not exact_lattice_ok(op):
                continue   # wide ops are served by the scalar fallback
            fid = fingerprint_id(op)
            if fid not in seen:
                seen.add(fid)
                fresh, fids = buckets.setdefault(
                    (len(op.inputs), len(op.outputs)), ([], [])
                )
                fresh.append(op)
                fids.append(fid)
        for fresh, fids in buckets.values():
            bs = sweep_ops(fresh, chip=self.chip, calib=self.calib)
            for i, fid in enumerate(fids):
                self._index[fid] = (bs, i)

    def _lookup(self, op: OpSpec) -> tuple[BatchSweep, int]:
        from repro_torch.core.planner import fingerprint_id

        fid = fingerprint_id(op)
        hit = self._index.get(fid)
        if hit is None:
            self.misses += 1
            self.add([op])
            return self._index[fid]
        self.hits += 1
        return hit

    def op_cost(
        self,
        op: OpSpec,
        mode: StaticMode | None = None,
        assignment: Assignment | None = None,
        allocation_bypass: bool = True,
        rinse: bool = True,
        launches: int = 1,
    ) -> cost_model.CostBreakdown:
        if not exact_lattice_ok(op):
            # Wide-op scalar fallback (greedy for adaptive, exact costs).
            if mode is StaticMode.ADAPTIVE and assignment is None:
                assignment = cost_model.adaptive_assignment(
                    op, self.chip, self.calib
                )
                mode = None
            return cost_model.op_cost(
                op, assignment=assignment, mode=mode, chip=self.chip,
                allocation_bypass=allocation_bypass, rinse=rinse,
                launches=launches, calib=self.calib,
            )
        bs, i = self._lookup(op)
        if mode is StaticMode.ADAPTIVE and assignment is None:
            bkey = (id(bs), i, allocation_bypass, rinse)
            assignment = self._best.get(bkey)
            if assignment is None:
                assignment, _ = bs.best(i, allocation_bypass, rinse)
                self._best[bkey] = assignment
            mode = None
        if assignment is not None:
            in_bits, out_bits = bs.bits_of_assignment(i, assignment)
        else:
            in_bits, out_bits = bs.bits_of_mode(
                i, mode or StaticMode.UNCACHED
            )
        key = (id(bs), i, in_bits, out_bits, allocation_bypass, rinse,
               launches)
        bd = self._bd.get(key)
        if bd is None:
            r = bs.row(in_bits, out_bits, allocation_bypass, rinse)
            bd = bs.breakdown_at(i, r, launches)
            self._bd[key] = bd
        return bd

    def workload_cost(
        self,
        ops: list[OpSpec],
        mode: StaticMode = StaticMode.UNCACHED,
        allocation_bypass: bool | None = None,
        rinse: bool | None = None,
        launches_per_op: int = 1,
    ) -> cost_model.CostBreakdown:
        """Drop-in analogue of ``cost_model.workload_cost`` over the table."""
        adaptive = mode is StaticMode.ADAPTIVE
        ab = adaptive if allocation_bypass is None else allocation_bypass
        rn = adaptive if rinse is None else rinse
        total = cost_model.CostBreakdown()
        for op in ops:
            total.add(self.op_cost(
                op, mode=mode, allocation_bypass=ab, rinse=rn,
                launches=launches_per_op,
            ))
        return total

    def best_assignment(
        self, op: OpSpec, allocation_bypass: bool = True, rinse: bool = True
    ) -> Assignment:
        if not exact_lattice_ok(op):
            return cost_model.adaptive_assignment(op, self.chip, self.calib)
        bs, i = self._lookup(op)
        a, _ = bs.best(i, allocation_bypass, rinse)
        return a

    def stats(self) -> dict:
        n = self.hits + self.misses
        return {
            "hits": self.hits,
            "misses": self.misses,
            "unique_ops": len(self._index),
            "hit_rate": self.hits / n if n else 0.0,
        }


# ---------------------------------------------------------------------------
# Serve-tier policy lattice (adaptive serve cache policy, DESIGN.md §5.7)
# ---------------------------------------------------------------------------
#
# The serve tier's analogue of the op lattice above: for one workload
# class, every (warm-retention fraction x eviction rank x bypass) combo is
# a row, the expected prefill work per arrival is the cost column, and
# the policy choice is an exact vectorized argmin — the same
# adaptive-matches-best-static shape the paper establishes for GPU cache
# policies, applied to KV page retention.  Ties resolve to the FIRST row
# (np.argmin), so the axis ordering below doubles as the no-signal
# default: retain the full budget, LRU rank, no bypass — optimistic
# retention until the counters prove a class is churn.

SERVE_WARM_FRACS = (1.0, 0.5, 0.0)      # descending: row 0 is optimistic
SERVE_EVICT_RANKS = ("lru", "reuse")    # warm-eviction ordering
SERVE_BYPASS = (False, True)            # bypass: never retain this class

SERVE_COMBOS = tuple(
    (wf, rank, byp)
    for wf in SERVE_WARM_FRACS
    for rank in SERVE_EVICT_RANKS
    for byp in SERVE_BYPASS
)

_SERVE_FEATURE_DEFAULTS = {
    "prompt_mean": 0.0,       # mean prompt tokens per arrival of the class
    "shared_tokens": 0.0,     # mean full-page-prefix tokens shareable/arrival
    "hit_rate": 0.0,          # observed retained-then-reattached rate (0..1)
    "churn": 0.0,             # observed retained-never-hit rate (0..1)
    "reuse_signal": 0.0,      # 1.0 when re-arrival intervals were observed
    "spec_acceptance": 0.0,   # accepted draft tokens per verify round
    "spec_k": 0,              # draft length (0 = spec off)
    "warm_budget": 0,         # allocator warm-tier budget, pages
    "page_size": 1,           # tokens per page
}


def serve_policy_argmin(features: dict) -> tuple[tuple, float]:
    """Exact argmin over the serve-policy lattice for one workload class.

    ``features`` are the runtime counters ``serve.adaptive`` accumulates
    (missing keys take the zero-signal defaults above).  The cost column
    is expected prefill work per arrival, in tokens:

        cost = prompt_mean
               - p_hit * shared_tokens                  (warm/prefix hits)
               + churn * retained_pages * page_size * w (dead retention)

    where ``p_hit = hit_rate * min(1, retained_tokens / shared_tokens)``
    (a chain the budget can't cover can't hit), retention is zero under
    bypass, the reuse-distance rank halves the churn penalty only when
    re-arrival intervals were actually observed (no signal -> no edge
    over LRU, so ties keep the default), and ``w = 1 / (1 +
    spec_acceptance * spec_k)`` — when speculation is absorbing decode
    cost, dead retained pages matter less relative to prefill savings.
    Returns ``(combo, cost)`` with ``combo`` a ``SERVE_COMBOS`` row.
    Placement-only by construction: the choice moves pages, never
    tokens.
    """
    f = {**_SERVE_FEATURE_DEFAULTS, **features}
    wf = np.array([c[0] for c in SERVE_COMBOS])
    reuse_rank = np.array([c[1] == "reuse" for c in SERVE_COMBOS])
    bypass = np.array([c[2] for c in SERVE_COMBOS])

    retained_tokens = np.where(
        bypass, 0.0, wf * f["warm_budget"] * f["page_size"]
    )
    coverage = np.minimum(
        1.0, retained_tokens / max(float(f["shared_tokens"]), 1.0)
    )
    p_hit = f["hit_rate"] * coverage
    rank_discount = np.where(reuse_rank & (f["reuse_signal"] > 0), 0.5, 1.0)
    churn_w = 1.0 / (1.0 + f["spec_acceptance"] * f["spec_k"])
    cost = (
        f["prompt_mean"]
        - p_hit * f["shared_tokens"]
        + f["churn"] * retained_tokens * churn_w * rank_discount
    )
    r = int(np.argmin(cost))
    return SERVE_COMBOS[r], float(cost[r])
