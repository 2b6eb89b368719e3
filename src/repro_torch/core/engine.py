"""CachePolicyEngine — the paper's adaptive mechanism as one composable object.

A copy of ``repro.core.engine`` (host-side Python and numpy): the port
keeps its own so it never imports the JAX package, and its plans and
modeled costs equal the reference's with ``==``.  Two changes: chip names
resolve through an explicit table (``CHIPS``: ``"tpu-v5e"``,
``"gem5-apu"``, ``"h100"``) and an unknown name raises, where the
reference maps every name but ``"gem5-apu"`` to v5e; and the default chip
is ``"h100"``, the card the port's entry points run on.

Pipeline per op: characterize (OpSpec) -> predict (PCby site table) ->
allocate (AB non-blocking VMEM planner) -> rinse (grid/flush order).
Output: a :class:`KernelPlan` consumed by the Pallas kernels, plus modeled
cost for reporting/feedback.

Planning is memoized (DESIGN.md §3): every plan/cost query routes through a
:class:`~repro.core.planner.Planner`, so an op that launches repeatedly
(RNN cells, each transformer layer) plans once and hits the
:class:`~repro.core.planner.PlanCache` thereafter.  ``plan_stats()``
exposes the hit/miss counters.

The engine also owns the trainer-level activation policy (remat) and is the
single switch between the paper's static baselines and the adaptive mode.
"""
from __future__ import annotations

import dataclasses

from repro_torch import hw
from repro_torch.core import allocator, remat
from repro_torch.core.planner import PlanCache, Planner
from repro_torch.core.policy import (
    Assignment,
    KernelPlan,
    OpSpec,
    Policy,
    StaticMode,
    static_assignment,
)
from repro_torch.core.predictor import PolicyPredictor


@dataclasses.dataclass
class EngineConfig:
    mode: StaticMode = StaticMode.ADAPTIVE
    allocation_bypass: bool = True
    rinse: bool = True
    chip_name: str = "h100"

    @property
    def chip(self) -> hw.Chip:
        return chip_by_name(self.chip_name)


CHIPS = {"tpu-v5e": hw.V5E, "gem5-apu": hw.PAPER_GPU, "h100": hw.H100}


def chip_by_name(name: str) -> hw.Chip:
    """The hardware model named ``name``; raises on a name not in ``CHIPS``."""
    try:
        return CHIPS[name]
    except KeyError:
        raise ValueError(
            f"unknown chip {name!r}: expected one of {sorted(CHIPS)}"
        ) from None


class CachePolicyEngine:
    def __init__(
        self,
        config: EngineConfig | None = None,
        predictor: PolicyPredictor | None = None,
        plan_cache: PlanCache | None = None,
    ):
        self.config = config or EngineConfig()
        self.chip = self.config.chip
        self.planner = Planner(chip=self.chip, cache=plan_cache)
        self.predictor = predictor or PolicyPredictor(
            chip=self.chip, planner=self.planner
        )

    # -- per-op planning ----------------------------------------------------

    def assign(self, op: OpSpec) -> Assignment:
        if self.config.mode is StaticMode.ADAPTIVE:
            return self.predictor.predict(
                op,
                allocation_bypass=self.config.allocation_bypass,
                rinse=self.config.rinse,
            )
        return static_assignment(op, self.config.mode)

    def plan_op(self, op: OpSpec) -> KernelPlan:
        return self.planner.plan(
            op,
            self.assign(op),
            allocation_bypass=self.config.allocation_bypass,
            rinse=self.config.rinse,
        )

    def cost(self, op: OpSpec, plan: KernelPlan | None = None):
        plan = plan or self.plan_op(op)
        breakdown = self.planner.cost(
            op,
            assignment=plan.assignment,
            allocation_bypass=self.config.allocation_bypass,
            rinse=self.config.rinse,
        )
        # Fold MXU starvation from shrunken tiles into compute time.
        eff = allocator.mxu_efficiency(plan, self.chip)
        breakdown.t_compute /= eff
        breakdown.t_total = (
            max(breakdown.t_compute, breakdown.t_hbm) + breakdown.t_overhead
        )
        return breakdown

    def feedback(self, op: OpSpec, plan: KernelPlan, measured_time: float) -> None:
        """Close the loop: compare against the bypass baseline and update
        the predictor's confidence counters."""
        baseline = self.planner.cost(
            op, mode=StaticMode.UNCACHED
        ).t_total
        benefit = (baseline - measured_time) / max(baseline, 1e-30)
        self.predictor.update(op, plan.assignment, benefit)

    # -- cache visibility ----------------------------------------------------

    @property
    def plan_cache(self) -> PlanCache:
        return self.planner.cache

    def plan_stats(self) -> dict:
        return self.planner.stats()

    # -- trainer-level activation policy ------------------------------------

    def remat_policy(
        self,
        activation_bytes_per_layer: float,
        n_layers: int,
        hbm_free_bytes: float | None = None,
    ) -> remat.RematPolicy:
        free = self.chip.hbm_bytes * 0.6 if hbm_free_bytes is None else hbm_free_bytes
        return remat.choose_policy(activation_bytes_per_layer, n_layers, free)

    # -- reporting -----------------------------------------------------------

    def kv_policy(self, kv_bytes_per_layer: int) -> Policy:
        """Serving-side: keep a layer's KV block resident in VMEM during the
        decode kernel only if it fits the budget share; else stream it."""
        if kv_bytes_per_layer <= self.chip.vmem_budget // 4:
            return Policy.RESIDENT
        return Policy.STREAM


def make_engine(
    mode: str = "adaptive",
    allocation_bypass: bool = True,
    rinse: bool = True,
    chip: str = "h100",
    plan_cache: PlanCache | None = None,
) -> CachePolicyEngine:
    return CachePolicyEngine(
        EngineConfig(
            mode=StaticMode(mode),
            allocation_bypass=allocation_bypass,
            rinse=rinse,
            chip_name=chip,
        ),
        plan_cache=plan_cache,
    )
