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

The port of ``repro.core.remat``: ``apply_remat`` wraps a layer body in
``torch.utils.checkpoint`` where the reference uses ``jax.checkpoint``.
"""
from __future__ import annotations

import enum
import functools

import torch
import torch.utils.checkpoint as tuc


class RematPolicy(enum.Enum):
    SAVE_ALL = "save_all"
    SAVE_DOTS = "save_dots"
    RECOMPUTE = "recompute"


def _dots_saveable(ctx, op, *args, **kwargs):
    """``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``: keep
    the outputs of dots without batch dimensions (``aten.mm``,
    ``aten.addmm``: the projections and MLP products, which ``x @ W`` on a
    (b, s, d) input reaches as a 2-D ``mm``), recompute everything else,
    ``aten.bmm`` included (the attention einsums, MoE's expert einsums)."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return tuc.CheckpointPolicy.MUST_SAVE
    return tuc.CheckpointPolicy.PREFER_RECOMPUTE


def apply_remat(fn, policy: RematPolicy):
    """Wrap a layer-apply function with the chosen activation policy.

    * ``SAVE_ALL``: ``fn`` itself;
    * ``SAVE_DOTS``: selective checkpointing that saves the outputs of
      ``aten.mm``/``aten.addmm`` only; it raises where this torch has no
      selective-checkpoint API, never falling back to ``RECOMPUTE``;
    * ``RECOMPUTE``: a plain non-reentrant checkpoint (the layer's inputs
      only).

    With grad mode off (a forward under ``torch.no_grad()``), nothing is
    saved for a backward, so the wrapper calls ``fn`` directly."""
    if policy is RematPolicy.SAVE_ALL:
        return fn
    context_fn = tuc.noop_context_fn
    if policy is RematPolicy.SAVE_DOTS:
        make = getattr(tuc, "create_selective_checkpoint_contexts", None)
        if make is None:
            raise NotImplementedError(
                f"SAVE_DOTS needs torch.utils.checkpoint."
                f"create_selective_checkpoint_contexts (torch "
                f"{torch.__version__} has none)")
        context_fn = functools.partial(make, _dots_saveable)

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        if not torch.is_grad_enabled():
            return fn(*args, **kwargs)
        return tuc.checkpoint(fn, *args, use_reentrant=False,
                              context_fn=context_fn, **kwargs)

    return wrapped


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
