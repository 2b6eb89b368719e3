"""Memory-policy vocabulary: the TPU adaptation of the paper's GPU cache policies.

A copy of ``repro.core.policy`` (host-side Python and numpy), line for
line: the port keeps its own so it never imports the JAX package, and
its plans and modeled costs equal the reference's with ``==``.

Paper policy -> TPU software-managed analogue (see DESIGN.md §2):

* ``Uncached``  -> every operand ``STREAM``ed (tiles fetched per use, never kept).
* ``CacheR``    -> reused *read* operands ``RESIDENT`` in VMEM across grid steps.
* ``CacheRW``   -> additionally, outputs ``RESIDENT_ACCUM``: accumulated in VMEM
  across the contraction grid dimension and written back once (write coalescing).
"""
from __future__ import annotations

import dataclasses
import enum
import math
import types
from typing import Any


class Policy(enum.Enum):
    """Per-operand memory policy."""

    STREAM = "stream"                  # bypass: fetch/write tiles exactly when used
    RESIDENT = "resident"              # pin whole operand in VMEM (read caching)
    RESIDENT_ACCUM = "resident_accum"  # accumulate output tiles in VMEM (write coalescing)


class StaticMode(enum.Enum):
    """The paper's static configurations plus the adaptive mode of §VII."""

    UNCACHED = "uncached"
    CACHER = "cacher"
    CACHERW = "cacherw"
    ADAPTIVE = "adaptive"


class WorkloadClass(enum.Enum):
    """Paper §VI.A classification."""

    MEMORY_INSENSITIVE = "memory_insensitive"
    REUSE_SENSITIVE = "reuse_sensitive"
    THROUGHPUT_SENSITIVE = "throughput_sensitive"


@dataclasses.dataclass(frozen=True)
class OperandProfile:
    """Analytical access characterization for one operand of one op.

    ``reuse_factor`` is the mean number of touches per element over the op's
    schedule (1.0 == no temporal reuse).  ``touched_bytes_stream`` is HBM
    traffic if the operand is STREAMed (refetched per revisit);
    ``unique_bytes`` is the traffic if RESIDENT (single fetch / single
    writeback).  ``contiguity`` in [0,1]: fraction of naturally sequential
    accesses under the default row-major schedule.
    """

    name: str
    role: str                 # "input" | "output"
    shape: tuple[int, ...]
    dtype: str
    unique_bytes: int
    touched_bytes_stream: int
    contiguity: float = 1.0
    # For outputs: number of partial-update visits per element (K-dim revisits).
    revisits: int = 1
    # Working set that must stay resident to actually capture the reuse
    # (the reuse *distance* in bytes).  None -> the whole operand.  Reuse whose
    # window exceeds VMEM capacity is NOT realizable by caching — this is what
    # makes FwLRN "throughput sensitive" in the paper despite its 5-wide
    # window reuse: the reuse distance exceeds the 4MB L2.
    reuse_window_bytes: int | None = None

    @property
    def is_output(self) -> bool:
        return self.role == "output"

    @property
    def window_bytes(self) -> int:
        return self.unique_bytes if self.reuse_window_bytes is None else self.reuse_window_bytes

    @property
    def reuse_factor(self) -> float:
        if self.unique_bytes == 0:
            return 1.0
        return self.touched_bytes_stream / self.unique_bytes

    def hbm_bytes(self, policy: Policy) -> int:
        """HBM traffic attributed to this operand under ``policy``."""
        if self.is_output:
            if policy is Policy.RESIDENT_ACCUM:
                return self.unique_bytes  # written back once
            # write-through partials: each revisit writes (and all but the
            # final revisit later re-reads) the element.
            return self.unique_bytes * max(1, 2 * self.revisits - 1)
        if policy is Policy.RESIDENT:
            return self.unique_bytes
        return self.touched_bytes_stream


def reuse_density(o: OperandProfile) -> float:
    """Traffic saved per resident byte — the single residency-priority
    metric shared by the greedy planners and the vectorized sweep (their
    orderings must agree exactly for the sweep==scalar invariants)."""
    return (o.touched_bytes_stream - o.unique_bytes) / max(o.window_bytes, 1)


@dataclasses.dataclass(frozen=True)
class OpSpec:
    """Shape-level description of one operator instance (a kernel launch)."""

    kind: str                                  # "matmul", "attention", "elementwise", ...
    operands: tuple[OperandProfile, ...]
    flops: float
    dtype: str = "bf16"
    meta: dict[str, Any] = dataclasses.field(default_factory=dict)
    name: str = ""

    def __post_init__(self):
        # Freeze meta: the plan cache fingerprints ops by structural content
        # (including meta), so in-place mutation would silently alias stale
        # cache entries.  A read-only view makes it fail loudly instead;
        # derive variants with dataclasses.replace(op, meta={...}).
        if not isinstance(self.meta, types.MappingProxyType):
            object.__setattr__(
                self, "meta", types.MappingProxyType(dict(self.meta))
            )

    def operand(self, name: str) -> OperandProfile:
        for o in self.operands:
            if o.name == name:
                return o
        raise KeyError(name)

    @property
    def inputs(self) -> tuple[OperandProfile, ...]:
        return tuple(o for o in self.operands if not o.is_output)

    @property
    def outputs(self) -> tuple[OperandProfile, ...]:
        return tuple(o for o in self.operands if o.is_output)

    def unique_bytes(self) -> int:
        return sum(o.unique_bytes for o in self.operands)

    def arithmetic_intensity(self) -> float:
        """FLOP per *unique* byte — the best-case (fully cached) intensity."""
        b = self.unique_bytes()
        return self.flops / b if b else math.inf


# An assignment maps operand name -> Policy.
Assignment = dict[str, Policy]


def static_assignment(op: OpSpec, mode: StaticMode) -> Assignment:
    """The paper's static policies applied uniformly to an op."""
    if mode is StaticMode.ADAPTIVE:
        raise ValueError("adaptive mode has no static assignment; use the engine")
    a: Assignment = {}
    for o in op.operands:
        if o.is_output:
            a[o.name] = (
                Policy.RESIDENT_ACCUM if mode is StaticMode.CACHERW else Policy.STREAM
            )
        else:
            a[o.name] = (
                Policy.RESIDENT
                if mode in (StaticMode.CACHER, StaticMode.CACHERW)
                else Policy.STREAM
            )
    return a


@dataclasses.dataclass
class KernelPlan:
    """Concrete, VMEM-feasible execution plan for one op.

    Produced by the engine (characterize -> predict -> allocate -> rinse) and
    consumed by the Pallas kernels in ``repro.kernels`` and by the cost model.
    """

    op: OpSpec
    assignment: Assignment
    block: dict[str, int]            # logical dim name -> tile size (MXU-aligned)
    grid_order: tuple[str, ...]      # loop nest, innermost last
    vmem_bytes: int                  # total VMEM claimed (incl. double buffers)
    demotions: tuple[str, ...] = ()  # operands demoted RESIDENT->STREAM (alloc bypass)
    shrink_events: int = 0           # times tiles were shrunk under pressure (stall proxy)
    rinse: bool = True               # contiguous flush scheduling enabled
    notes: str = ""

    def policy(self, operand: str) -> Policy:
        return self.assignment[operand]
