"""Public decode-attention entry points with split planning from the
policy engine (the port of ``repro.kernels.decode_attention.ops``).

The split count is a policy decision: more splits means more parallelism
on the zero-reuse KV stream but more partial (acc, m, l) write-through
traffic, the STREAM-output trade-off the cost model prices.  With a
``CachePolicyEngine`` (or its plan), the engine's PlanCache-memoized plan
for the decode-shaped attention op supplies the target: one split per
planned KV block (``ServeEngine.decode_plan`` flows through here).
Without one the target is the reference's default of 8.
"""
from __future__ import annotations

import torch

from repro_torch.core import CachePolicyEngine
from repro_torch.core.characterize import attention_op
from repro_torch.kernels.common import cdiv
from repro_torch.kernels.decode_attention import decode_attention as _kern


def plan_splits(
    s: int,
    bkv: int,
    target_parallelism: int = 8,
    *,
    plan=None,
) -> int:
    """Enough splits to feed the device without drowning in partials.

    ``blocks`` counts the padded grid's KV blocks (cdiv), so the split
    count never exceeds the real parallelism available.  ``plan`` (a
    ``core.policy.KernelPlan``) overrides the default target with the
    engine's own block decision: one split per engine-planned KV block.
    """
    blocks = max(1, cdiv(s, bkv))
    if plan is not None:
        planned_bkv = int(plan.block.get("bkv", bkv)) or bkv
        target_parallelism = max(1, cdiv(s, planned_bkv))
    return max(1, min(target_parallelism, blocks))


def _engine_plan(engine: CachePolicyEngine, b, hq, hkv, s, d):
    """The engine's plan for a decode-shaped attention op (sq == 1), via
    the engine's own PlanCache: repeat calls are hits, not re-sweeps."""
    return engine.plan_op(attention_op(
        b, hq, max(1, hkv), 1, s, d, causal=False, name="decode_attention",
    ))


def decode_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    lengths: torch.Tensor | None = None,
    *,
    scale: float | None = None,
    engine: CachePolicyEngine | None = None,
    bkv: int | None = None,
    splits: int | None = None,
) -> torch.Tensor:
    """Dense split-KV decode attention, q (b, hq, d), k/v (b, hkv, s, d)."""
    s = k.shape[2]
    bkv = bkv or 512
    if splits is None:
        plan = None
        if engine is not None:
            plan = _engine_plan(engine, q.shape[0], q.shape[1], k.shape[1],
                                s, q.shape[2])
        splits = plan_splits(s, bkv, plan=plan)
    return _kern.decode_attention(q, k, v, lengths, scale=scale,
                                  bkv=min(bkv, s), splits=splits)


def paged_decode_attention(
    q: torch.Tensor,          # (b, hq, d)
    k_pool: torch.Tensor,     # (N, page_size, hkv, d)
    v_pool: torch.Tensor,     # (N, page_size, hkv, d)
    pages: torch.Tensor,      # (b, P) int32, -1 = unmapped
    lengths: torch.Tensor | None = None,
    *,
    scale: float | None = None,
    engine: CachePolicyEngine | None = None,
    splits: int | None = None,
) -> torch.Tensor:
    """Paged split-KV decode attention, the pool read in place.  Split
    planning runs over the dense-equivalent width ``P * page_size`` with
    ``bkv = page_size``, so with equal splits it is bitwise equal to
    ``gather_pages`` + :func:`decode_attention`."""
    psz, P = k_pool.shape[1], pages.shape[1]
    if splits is None:
        plan = None
        if engine is not None:
            plan = _engine_plan(engine, q.shape[0], q.shape[1],
                                k_pool.shape[2], P * psz, q.shape[2])
        splits = plan_splits(P * psz, psz, plan=plan)
    return _kern.paged_decode_attention(q, k_pool, v_pool, pages, lengths,
                                        scale=scale, splits=splits)
