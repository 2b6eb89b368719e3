"""Sequence-parallel flash-decode across ranks (the port of
``repro.distributed.sp_decode``).

The long_500k cell: batch=1, KV cache of 524288 tokens — no batch axis to
shard.  The cache's sequence dim is sharded over the ranks of a group
(the ``data`` axis); every rank computes flash-decode over its local KV
shard with the split-KV decode kernel
(``kernels.decode_attention.decode_attention_partials``: the CUDA kernel
on the card, its plain version on the CPU), and the partial (acc, max,
sum) triples merge with the same log-sum-exp combine the kernel's splits
use.  This makes decode bandwidth scale with the number of ranks — the
STREAM policy executed fleet-wide.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.distributed.collectives import all_reduce
from repro_torch.kernels.decode_attention import decode_attention as dec
from repro_torch.kernels.decode_attention import ops as dec_ops


def local_lengths(lengths: torch.Tensor, shard_start: int,
                  s_local: int) -> torch.Tensor:
    """Each slot's live positions inside the shard ``[shard_start,
    shard_start + s_local)``, on the lengths' device (no host sync)."""
    return (lengths.to(torch.int64) - shard_start).clamp(0, s_local).to(
        torch.int32).contiguous()


def local_partials(q, k, v, lengths, shard_start: int, scale: float,
                   splits: int | None = None):
    """One shard's flash-decode partials over its local KV slice -> (acc
    (b, hq, d) unnormalised, m (b, hq), l (b, hq)), fp32: the kernel's
    split partials merged to one triple.  A shard with no live position
    gives m = -1e30, l = 0, acc = 0."""
    s_local = k.shape[2]
    bkv = min(512, s_local)
    if splits is None:
        splits = dec_ops.plan_splits(s_local, bkv)
    return merge_splits(*dec.decode_attention_partials(
        q, k, v, local_lengths(lengths, shard_start, s_local), scale=scale,
        bkv=bkv, splits=splits))


def merge_splits(acc, m, l):
    """A kernel's split partials (acc (b, hq, splits, d), m and l (b, hq,
    splits)) merged to one (acc, m, l) triple, still unnormalised."""
    m_loc = m.amax(dim=-1)
    w = torch.exp(m - m_loc[..., None])
    return (acc * w[..., None]).sum(dim=2), m_loc, (l * w).sum(dim=-1)


def merge_partials(acc, m, l, group=None) -> torch.Tensor:
    """The log-sum-exp merge of every rank's (acc, m, l) -> (b, hq, d)
    fp32, the same on every rank: an all-reduce with MAX of m, then one
    with SUM of acc * w and l * w (sent together)."""
    m_glob = all_reduce(m.clone(), dist.ReduceOp.MAX, group)
    w = torch.exp(m - m_glob)
    num = acc * w[..., None]
    den = l * w
    both = all_reduce(torch.cat([num.reshape(-1), den.reshape(-1)]),
                      dist.ReduceOp.SUM, group)
    num = both[:num.numel()].reshape(num.shape)
    den = both[num.numel():].reshape(den.shape)
    return num / den.clamp_min(1e-30)[..., None]


def sp_decode_attention(
    q: torch.Tensor,        # (b, hq, d), the same on every rank
    k: torch.Tensor,        # (b, hkv, S / ranks, d): this rank's shard
    v: torch.Tensor,
    lengths: torch.Tensor,  # (b,) live lengths over the whole sequence
    group=None,
    scale: float | None = None,
    splits: int | None = None,
) -> torch.Tensor:
    """Distributed flash-decode: rank r of ``group`` holds positions
    ``[r * s_local, (r + 1) * s_local)``; partial softmax per shard, merged
    across ranks.  Returns (b, hq, d) in q's dtype on every rank."""
    d = q.shape[-1]
    scale = float(scale if scale is not None else d ** -0.5)
    s_local = k.shape[2]
    start = dist.get_rank(group) * s_local
    acc, m, l = local_partials(q, k, v, lengths, start, scale, splits)
    return merge_partials(acc, m, l, group).to(q.dtype)


def reference(q, k, v, lengths, scale=None):
    """One rank's answer over the whole cache: the decode kernel's plain
    version."""
    return dec.decode_attention_plain(q, k, v, lengths, scale=scale)
