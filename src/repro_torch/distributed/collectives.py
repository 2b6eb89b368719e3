"""Distributed-optimization collectives over a ``torch.distributed`` group
(the port of ``repro.distributed.collectives``): rinsed (bucketed)
reduction and int8-compressed gradient all-reduce with error feedback.

* ``bucketed_all_reduce`` — instead of one collective per tensor (small
  scattered flushes) or one monolithic end-of-step flush, gradients are
  grouped into contiguous size-bounded buckets by the rinse scheduler
  (`repro_torch.core.rinse.bucket_flush_schedule`) and reduced
  bucket-by-bucket — the distributed twin of the paper's
  row-locality-aware rinsing, and the unit at which reduction overlaps the
  backward pass.
* ``compressed_all_reduce`` — int8-quantized all-reduce with a shared scale
  and ERROR FEEDBACK (the quantization residual is carried into the next
  step), cutting gradient collective bytes 4x vs fp32: the int8 values are
  all-gathered and summed in int32 on each rank.

**Gloo and the card.**  NCCL will not put two ranks on one device, so
ranks that share a card run over gloo.  Under gloo every collective here
copies a CUDA tensor to the host, runs there and copies the result back,
explicitly; the arithmetic stays on the card.  The host side is one
page-locked buffer a process, grown to the largest collective staged so
far and reused (:func:`_host`): the copies run at the bus's rate and no
call pays for fresh host pages.  ``STAGED`` counts such collectives and
the bytes they moved each way.

**The record.**  Every collective the port issues goes through
:func:`all_reduce`, :func:`all_gather` or :func:`reduce_scatter`
(``tensor_parallel``, ``fsdp``, ``sp_decode``, the trainer and the
optimizer call nothing else).  While a :func:`recording` context is
open each call appends ``(kind, result bytes, group size)`` to it: the
dry run's collective account (``launch.roofline.collective_record``).
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.distributed as dist

from repro_torch.core.rinse import bucket_flush_schedule

STAGED = {"collectives": 0, "bytes": 0}
# The open recording's list, None when none is open.
_RECORD: list | None = None
# The process's page-locked staging buffer (bytes), None until needed.
_PINNED: torch.Tensor | None = None


@contextlib.contextmanager
def recording():
    """Yield a list that collects ``(kind, result_bytes, group_size)`` of
    every collective issued inside the context (``kind`` as the
    reference's HLO names it: ``"all-reduce"``, ``"all-gather"``,
    ``"reduce-scatter"``)."""
    global _RECORD
    outer, _RECORD = _RECORD, []
    try:
        yield _RECORD
    finally:
        _RECORD = outer


def _note(kind: str, result_bytes: int, group) -> None:
    if _RECORD is not None:
        _RECORD.append((kind, result_bytes, dist.get_world_size(group)))


def _staged(t: torch.Tensor, group) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _count(t: torch.Tensor) -> None:
    STAGED["collectives"] += 1
    STAGED["bytes"] += t.numel() * t.element_size()


def _host(*like: tuple) -> list[torch.Tensor]:
    """Host tensors for one staged collective, one a ``(shape, dtype)`` in
    ``like``, laid out in the process's page-locked buffer (grown when it
    is too small).  They are valid until the next call, so a caller copies
    its results to the card before it returns."""
    global _PINNED
    sizes = [math.prod(shape) * dtype.itemsize for shape, dtype in like]
    offsets = [0]
    for n in sizes:
        offsets.append(offsets[-1] + -(-n // 64) * 64)
    if _PINNED is None or _PINNED.numel() < offsets[-1]:
        _PINNED = None          # the old buffer goes before the new one
        _PINNED = torch.empty(offsets[-1], dtype=torch.uint8,
                              pin_memory=True)
    return [_PINNED[o:o + n].view(dtype).view(shape)
            for o, n, (shape, dtype) in zip(offsets, sizes, like)]


def all_reduce(t: torch.Tensor, op=dist.ReduceOp.SUM,
               group=None) -> torch.Tensor:
    """``t`` reduced over ``group``, in place; returns ``t``."""
    _note("all-reduce", t.numel() * t.element_size(), group)
    if _staged(t, group):
        _count(t)
        (host,) = _host((t.shape, t.dtype))
        host.copy_(t)
        dist.all_reduce(host, op=op, group=group)
        t.copy_(host)
    else:
        dist.all_reduce(t, op=op, group=group)
    return t


def all_gather(t: torch.Tensor, group=None) -> list[torch.Tensor]:
    """Every rank's ``t`` (equal shapes), in rank order of ``group``."""
    n = dist.get_world_size(group)
    _note("all-gather", n * t.numel() * t.element_size(), group)
    if _staged(t, group):
        _count(t)
        host, *parts = _host(*[(t.shape, t.dtype)] * (n + 1))
        host.copy_(t.detach())
        dist.all_gather(parts, host, group=group)
        return [p.to(t.device) for p in parts]
    src = t.detach().contiguous()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    return parts


def reduce_scatter(t: torch.Tensor, group=None) -> torch.Tensor:
    """This rank's block of ``t`` summed over ``group``: ``t`` split along
    its first dimension into one block a rank (in rank order), each block
    summed over the ranks, and this rank's sum returned (a new tensor)."""
    n = dist.get_world_size(group)
    if t.shape[0] % n:
        raise ValueError(f"reduce_scatter: {t.shape[0]} rows do not split "
                         f"over {n} ranks")
    src = t.detach().contiguous()
    out_shape = (t.shape[0] // n, *t.shape[1:])
    _note("reduce-scatter", src.numel() // n * src.element_size(), group)
    if _staged(t, group):
        _count(t)
        host, out = _host((src.shape, src.dtype), (out_shape, src.dtype))
        host.copy_(src)
        dist.reduce_scatter_tensor(out, host, group=group)
        return out.to(t.device)
    out = torch.empty(out_shape, dtype=src.dtype, device=src.device)
    dist.reduce_scatter_tensor(out, src, group=group)
    return out


def bucketed_all_reduce(grads: list[torch.Tensor], group=None,
                        bucket_bytes: int = 32 * 1024 * 1024
                        ) -> list[torch.Tensor]:
    """Sum a list of tensors over ``group`` in rinse-scheduled contiguous
    buckets: each bucket concatenated, all-reduced once, split back (each
    output in its input's dtype and shape)."""
    sizes = [g.numel() * g.element_size() for g in grads]
    out: list = [None] * len(grads)
    for bucket in bucket_flush_schedule(sizes, bucket_bytes):
        flat = torch.cat([grads[i].reshape(-1) for i in bucket])
        all_reduce(flat, dist.ReduceOp.SUM, group)
        off = 0
        for i in bucket:
            n = grads[i].numel()
            out[i] = flat[off:off + n].reshape(grads[i].shape).to(
                grads[i].dtype)
            off += n
    return out


def quantize_int8(x: torch.Tensor, amax: torch.Tensor | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (q int8, scale): ``x ~ q * scale``, the scale set by ``amax``
    (default: the largest |x|)."""
    if amax is None:
        amax = torch.max(torch.abs(x))
    scale = amax / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def shared_amax(x: torch.Tensor, group=None) -> torch.Tensor:
    """The largest |x| on any rank of ``group`` (one scalar all-reduced
    with MAX)."""
    return all_reduce(torch.max(torch.abs(x)).reshape(1),
                      dist.ReduceOp.MAX, group)[0]


def compressed_all_reduce(g: torch.Tensor, error: torch.Tensor, group=None
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """int8 all-reduce with error feedback -> (reduced mean, new error).

    A shared scale is agreed by an all-reduce with MAX of one scalar, so
    the int32 sum dequantizes exactly; the local quantization residual is
    carried by the caller into the next step's gradient (error feedback
    keeps compression unbiased over time).  ``torch.round`` rounds half to
    even, as ``jnp.round`` does."""
    g_fb = (g + error).float()
    q, scale = quantize_int8(g_fb, shared_amax(g_fb, group))
    new_error = g_fb - q.float() * scale
    # The int8 values go on the wire (all-gathered: a quarter of fp32's
    # bytes) and are summed in int32 on each rank, which is exact and so
    # equals an int32 all-reduce.
    red = torch.stack([p.to(torch.int32) for p in all_gather(q, group)]
                      ).sum(dim=0, dtype=torch.int32).float()
    return red * scale / dist.get_world_size(group), new_error
