"""The paper's primary contribution: adaptive memory policies for MI ops.

Public API:
    Policy, StaticMode, WorkloadClass, OperandProfile, OpSpec, KernelPlan
    characterize.{matmul_op, attention_op, elementwise_op, rowwise_op,
                  window_op, conv2d_op, classify_workload}
    cost_model.{op_cost, workload_cost, adaptive_assignment}
    allocator.plan_op, rinse.DirtyIndex, predictor.PolicyPredictor
    engine.{CachePolicyEngine, make_engine}
    planner.{PlanCache, Planner, fingerprint_op}
    sweep.{sweep_ops, optimal_assignment, SweepTable}
"""
from repro_torch.core.policy import (  # noqa: F401
    Assignment,
    KernelPlan,
    OperandProfile,
    OpSpec,
    Policy,
    StaticMode,
    WorkloadClass,
    static_assignment,
)
from repro_torch.core.engine import CachePolicyEngine, EngineConfig, make_engine  # noqa: F401
from repro_torch.core.planner import PlanCache, Planner, fingerprint_op  # noqa: F401
from repro_torch.core.sweep import SweepTable, optimal_assignment, sweep_ops  # noqa: F401
