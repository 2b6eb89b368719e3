"""Roofline terms of a dry-run cell (the port of ``repro.launch.roofline``).

Three terms per (arch, shape, mesh), in seconds, per rank, against a
``hw.Chip`` (the port's dry run passes ``hw.H100``):

    t_compute    = FLOPs/rank   / peak_flops_bf16
    t_memory     = bytes/rank   / hbm_bw
    t_collective = sum(bytes_moved) / (links x link bandwidth)

The reference parses collectives out of XLA's optimized HLO text; the
port records the ones it actually issues instead: every collective goes
through ``distributed.collectives.all_reduce`` or ``all_gather``, which
note ``(kind, result bytes, group size)`` while a
``collectives.recording()`` is open, and :func:`collective_record` turns
those notes into the reference's per-kind record with the same ring
factors (:func:`_moved_bytes`).
"""
from __future__ import annotations

import math
from typing import Any

from repro_torch import hw
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.launch.mesh import axis_sizes

_COLL_KINDS = (
    "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
    "collective-permute",
)


# Ring-algorithm bytes-moved-per-participant factors, as multiples of the
# RESULT size (a rank's local result).
#   all-gather: result is the gathered (global) tensor; moved ~ (n-1)/n x result
#   all-reduce: result local; ring moves 2 x (n-1)/n x size
#   reduce-scatter: result is the scattered shard; moved ~ (n-1) x result
#   all-to-all / collective-permute: ~ 1 x result
def _moved_bytes(kind: str, result_bytes: float, group: int) -> float:
    g = max(group, 2)
    if kind == "all-gather":
        return result_bytes * (g - 1) / g
    if kind == "all-reduce":
        return 2.0 * result_bytes * (g - 1) / g
    if kind == "reduce-scatter":
        return result_bytes * (g - 1)
    return result_bytes


def collective_record(notes) -> dict[str, Any]:
    """The reference's ``parse_collectives`` record from the port's notes
    (``(kind, result_bytes, group_size)`` each): ``per_kind`` (count,
    result_bytes, moved_bytes), ``total_moved_bytes``, ``total_count``."""
    per_kind: dict[str, dict[str, float]] = {
        k: {"count": 0, "result_bytes": 0.0, "moved_bytes": 0.0}
        for k in _COLL_KINDS
    }
    for kind, rb, group in notes:
        per_kind[kind]["count"] += 1
        per_kind[kind]["result_bytes"] += float(rb)
        per_kind[kind]["moved_bytes"] += _moved_bytes(kind, float(rb), group)
    return {"per_kind": per_kind,
            "total_moved_bytes": sum(v["moved_bytes"]
                                     for v in per_kind.values()),
            "total_count": sum(v["count"] for v in per_kind.values())}


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """MODEL_FLOPS: 6*N*D train (fwd+bwd), 2*N*D forward-only."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    tokens = shape.global_batch  # one token per sequence
    return 2.0 * n * tokens


def roofline_terms(
    cfg: ModelConfig,
    shape: ShapeConfig,
    mesh,
    cost: dict,
    colls: dict,
    mem: dict,
    chip: hw.Chip = hw.V5E,
) -> dict[str, Any]:
    n_chips = math.prod(axis_sizes(mesh).values())
    flops = float(cost.get("flops", 0.0))
    bytes_accessed = float(cost.get("bytes accessed", 0.0))
    # The dry run's counts are a rank's (per-device) numbers.
    t_compute = flops / chip.peak_flops_bf16
    t_memory = bytes_accessed / chip.hbm_bw
    t_coll = colls["total_moved_bytes"] / (chip.ici_bw_per_link * chip.ici_links)
    terms = {"compute": t_compute, "memory": t_memory, "collective": t_coll}
    dominant = max(terms, key=terms.get) if any(terms.values()) else "n/a"
    mf = model_flops(cfg, shape)
    mf_chip = mf / n_chips
    useful = mf_chip / flops if flops else 0.0
    bound = max(terms.values()) if any(terms.values()) else 0.0
    # Roofline fraction: useful model FLOP throughput vs peak, given the
    # bound set by the dominant term.
    frac = (mf_chip / chip.peak_flops_bf16) / bound if bound else 0.0
    hbm_need = (mem or {}).get("argument_size_in_bytes", 0) + (mem or {}).get(
        "temp_size_in_bytes", 0
    )
    return {
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": t_coll,
        "dominant": dominant,
        "model_flops_total": mf,
        "model_flops_per_chip": mf_chip,
        "useful_compute_ratio": useful,
        "roofline_fraction": frac,
        "fits_hbm": bool(hbm_need <= chip.hbm_bytes) if hbm_need else None,
        "hbm_need_bytes": hbm_need,
    }
