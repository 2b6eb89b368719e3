"""Site-based policy prediction — the PC-based L2 bypass analogue (§VII.C).

A copy of ``repro.core.predictor`` (host-side Python and numpy), line for
line: the port keeps its own so it never imports the JAX package, and
its plans and modeled costs equal the reference's with ``==``.

The paper uses the load instruction's program counter to index a reuse
predictor [54].  On a statically-scheduled TPU the natural "PC" is the *op
site*: (op kind, operand role, size class, reuse class, dtype) — every
texturally distinct access site in the traced program maps to one key.

The predictor is seeded from the analytical cost model — the *exact*
lattice optimum of ``core.sweep`` (never worse than the greedy walk;
DESIGN.md §3) — then updated with observed benefit via saturating
confidence counters, mirroring the hardware predictor's
increment/decrement behaviour.  State persists to JSON — the software
equivalent of the paper's own methodology of reusing MIOpen's tuned-kernel
database across runs.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os

from repro_torch import hw
from repro_torch.core.cost_model import CALIB, CostCalib
from repro_torch.core.policy import Assignment, OperandProfile, OpSpec, Policy

_CONF_MAX = 3    # 2-bit saturating counter, as in [54]
_CONF_INIT = 2
_CONF_FLIP = 0


@dataclasses.dataclass(frozen=True)
class SiteKey:
    op_kind: str
    operand: str
    role: str
    size_class: int     # log2 bucket of unique bytes
    reuse_class: int    # log2 bucket of reuse factor
    dtype: str

    @classmethod
    def from_profile(cls, op: OpSpec, o: OperandProfile) -> "SiteKey":
        return cls(
            op_kind=op.kind,
            operand=o.name,
            role=o.role,
            size_class=int(math.log2(max(o.unique_bytes, 1))),
            reuse_class=int(math.log2(max(o.reuse_factor, 1.0)) + 0.5),
            dtype=str(o.dtype),
        )

    def encode(self) -> str:
        return "|".join(
            [self.op_kind, self.operand, self.role, str(self.size_class),
             str(self.reuse_class), self.dtype]
        )

    @classmethod
    def decode(cls, s: str) -> "SiteKey":
        k, operand, role, sc, rc, dt = s.split("|")
        return cls(k, operand, role, int(sc), int(rc), dt)


@dataclasses.dataclass
class _Entry:
    policy: str
    confidence: int = _CONF_INIT
    updates: int = 0


class PolicyPredictor:
    """Per-site policy table with saturating-counter feedback."""

    def __init__(
        self,
        chip: hw.Chip = hw.V5E,
        calib: CostCalib = CALIB,
        planner=None,
    ):
        self.chip = chip
        self.calib = calib
        self.table: dict[SiteKey, _Entry] = {}
        if planner is None:
            from repro_torch.core.planner import Planner  # local: avoid cycle

            planner = Planner(chip=chip, calib=calib)
        self.planner = planner

    # -- prediction ---------------------------------------------------------

    def predict(
        self,
        op: OpSpec,
        allocation_bypass: bool = True,
        rinse: bool = True,
    ) -> Assignment:
        """Site-table prediction, seeded from the lattice optimum under the
        machine model actually in force (AB/rinse knobs)."""
        seed = self.planner.optimal_assignment(
            op, allocation_bypass=allocation_bypass, rinse=rinse
        )
        out: Assignment = {}
        for o in op.operands:
            key = SiteKey.from_profile(op, o)
            entry = self.table.get(key)
            if entry is None:
                entry = _Entry(policy=seed[o.name].value)
                self.table[key] = entry
            out[o.name] = Policy(entry.policy)
        return out

    # -- feedback -----------------------------------------------------------

    def update(self, op: OpSpec, assignment: Assignment, benefit: float) -> None:
        """Reinforce or decay each site's decision.

        ``benefit`` > 0: the chosen assignment beat the bypass baseline.
        ``benefit`` < 0: it lost — decrement; at zero confidence the site
        flips to STREAM (bypass), like the hardware predictor's default.
        """
        for o in op.operands:
            key = SiteKey.from_profile(op, o)
            entry = self.table.get(key)
            if entry is None:
                entry = _Entry(policy=assignment[o.name].value)
                self.table[key] = entry
            if Policy(entry.policy) is not assignment[o.name]:
                # Feedback describes a policy this site no longer uses.
                continue
            entry.updates += 1
            if benefit >= 0:
                entry.confidence = min(_CONF_MAX, entry.confidence + 1)
            else:
                entry.confidence -= 1
                if entry.confidence <= _CONF_FLIP and (
                    Policy(entry.policy) is not Policy.STREAM
                ):
                    # Losing caching policies flip to bypass and stay — the
                    # safe default, exactly the hardware predictor's bias.
                    entry.policy = Policy.STREAM.value
                    entry.confidence = _CONF_INIT

    # -- persistence --------------------------------------------------------

    def save(self, path: str) -> None:
        blob = {
            k.encode(): dataclasses.asdict(v) for k, v in self.table.items()
        }
        tmp = path + ".tmp"
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(tmp, "w") as f:
            json.dump(blob, f, indent=1, sort_keys=True)
        os.replace(tmp, path)

    def load(self, path: str) -> "PolicyPredictor":
        with open(path) as f:
            blob = json.load(f)
        self.table = {
            SiteKey.decode(k): _Entry(**v) for k, v in blob.items()
        }
        return self

    def __len__(self) -> int:
        return len(self.table)
