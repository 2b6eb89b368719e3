"""Public decode-attention entry points with split planning.

``plan_splits`` is a copy of ``repro.kernels.decode_attention.ops.
plan_splits`` without the policy-engine plan (``repro.core`` is not
ported yet): the split count is ``min(target_parallelism, blocks)`` with
``blocks`` the padded grid's KV-block count (cdiv).  The default target of
8 counts TPU cores; an H100-aware target is a later change.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.common import cdiv
from repro_torch.kernels.decode_attention import decode_attention as _kern


def plan_splits(s: int, bkv: int, target_parallelism: int = 8) -> int:
    """Enough splits to feed the device without drowning in partials."""
    blocks = max(1, cdiv(s, bkv))
    return max(1, min(target_parallelism, blocks))


def decode_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    lengths: torch.Tensor | None = None,
    *,
    scale: float | None = None,
    bkv: int | None = None,
    splits: int | None = None,
) -> torch.Tensor:
    """Dense split-KV decode attention, q (b, hq, d), k/v (b, hkv, s, d)."""
    s = k.shape[2]
    bkv = bkv or 512
    if splits is None:
        splits = plan_splits(s, bkv)
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
    splits: int | None = None,
) -> torch.Tensor:
    """Paged split-KV decode attention, the pool read in place.  Split
    planning runs over the dense-equivalent width ``P * page_size`` with
    ``bkv = page_size``, so with equal splits it is bitwise equal to
    ``gather_pages`` + :func:`decode_attention`."""
    psz, P = k_pool.shape[1], pages.shape[1]
    if splits is None:
        splits = plan_splits(P * psz, psz)
    return _kern.paged_decode_attention(q, k_pool, v_pool, pages, lengths,
                                        scale=scale, splits=splits)
