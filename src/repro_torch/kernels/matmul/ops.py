"""Public policy-planned matmul (the port of ``repro.kernels.matmul.ops``;
no ``interpret`` flag, and no padding: the kernel masks ragged edges).

With an engine, the schedule comes from the paper's characterize ->
predict -> allocate -> rinse pipeline (``engine.plan_op(matmul_op(...))``)
by the reference's rule; explicit keyword arguments override it for
ablations.  The planner is asked with the reference's dtype names
(``device.dtype_name``), so plans and plan-cache fingerprints equal the
JAX package's.
"""
from __future__ import annotations

import torch

from repro_torch.core import CachePolicyEngine, Policy
from repro_torch.core.characterize import matmul_op
from repro_torch.device import dtype_name
from repro_torch.kernels.matmul import matmul as _kern


def resolve_schedule(
    m: int,
    k: int,
    n: int,
    dtype: str,
    *,
    engine: CachePolicyEngine | None = None,
    bm: int | None = None,
    bn: int | None = None,
    bk: int | None = None,
    split_k: int | None = None,
):
    """(plan, schedule) for an (m, k) @ (k, n) product of ``dtype`` (a
    name, ``"bfloat16"``): ``plan`` is the engine's ``KernelPlan`` (None
    without an engine) and ``schedule`` the kernel's keyword arguments
    ``bm, bn, bk, order, split_k``, resolved exactly as the reference's
    ``ops.matmul`` resolves them."""
    plan = None
    if engine is not None:
        plan = engine.plan_op(matmul_op(m, k, n, dtype=dtype))
        bm = bm or plan.block["bm"]
        bn = bn or plan.block["bn"]
        bk = bk or plan.block["bk"]
        order = "mnk" if plan.grid_order[0] == "m" else "nmk"
        if split_k is None:
            split_k = 1 if plan.policy("out") is Policy.RESIDENT_ACCUM else max(
                2, k // max(bk, 1) // 4
            )
    else:
        bm, bn, bk = bm or 256, bn or 256, bk or 256
        order = "mnk"
        split_k = split_k or 1
    return plan, dict(bm=min(bm, m), bn=min(bn, n), bk=min(bk, k),
                      order=order, split_k=split_k)


def matmul(
    a: torch.Tensor,
    b: torch.Tensor,
    *,
    engine: CachePolicyEngine | None = None,
    bm: int | None = None,
    bn: int | None = None,
    bk: int | None = None,
    split_k: int | None = None,
    out_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """Policy-planned blocked matmul: a (m, k) @ b (k, n) in ``out_dtype``
    (default a's)."""
    m, k = a.shape
    _, n = b.shape
    _, schedule = resolve_schedule(
        m, k, n, dtype_name(a.dtype), engine=engine, bm=bm, bn=bn, bk=bk,
        split_k=split_k,
    )
    return _kern.matmul(a, b, **schedule, out_dtype=out_dtype or a.dtype)
