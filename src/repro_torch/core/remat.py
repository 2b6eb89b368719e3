"""Activation caching policies for training — the paper's question, one level up.

Saving activations for the backward pass IS a caching decision: HBM is the
"cache" for the backward pass's recompute stream.  The same
characterize->predict->plan structure assigns a per-layer policy:

* ``SAVE_ALL``   -> RESIDENT: keep every activation (fast bwd, max HBM)
* ``SAVE_DOTS``  -> selective: keep matmul outputs only (the reuse-dense
  accesses — the PCby criterion applied to activations)
* ``RECOMPUTE``  -> STREAM: full rematerialization (min HBM, ~+33% FLOPs)

``choose_policy`` applies allocation-bypass logic to the HBM budget: prefer
residency, demote toward recompute only under capacity pressure, never "OOM
stall".

A copy of the framework-free part of ``repro.core.remat``: the policy
enum, ``choose_policy`` and ``extra_flops_factor``.  ``apply_remat``
(``jax.checkpoint`` in the reference, ``torch.utils.checkpoint`` here)
comes with the port of ``train/``.
"""
from __future__ import annotations

import enum


class RematPolicy(enum.Enum):
    SAVE_ALL = "save_all"
    SAVE_DOTS = "save_dots"
    RECOMPUTE = "recompute"


def choose_policy(
    activation_bytes_per_layer: float,
    n_layers: int,
    hbm_free_bytes: float,
    safety_frac: float = 0.9,
) -> RematPolicy:
    """Pick the most residency-friendly policy that fits the HBM budget.

    ``activation_bytes_per_layer`` is the per-device saved-activation
    footprint of one layer under SAVE_ALL; SAVE_DOTS is modeled at ~45% of
    that (matmul outputs only); RECOMPUTE at ~6% (layer boundaries only).
    """
    budget = hbm_free_bytes * safety_frac
    full = activation_bytes_per_layer * n_layers
    if full <= budget:
        return RematPolicy.SAVE_ALL
    if full * 0.45 <= budget:
        return RematPolicy.SAVE_DOTS
    return RematPolicy.RECOMPUTE


def extra_flops_factor(policy: RematPolicy) -> float:
    """Forward-recompute overhead factor on total train-step FLOPs."""
    return {
        RematPolicy.SAVE_ALL: 1.0,
        RematPolicy.SAVE_DOTS: 1.12,
        RematPolicy.RECOMPUTE: 1.33,
    }[policy]
