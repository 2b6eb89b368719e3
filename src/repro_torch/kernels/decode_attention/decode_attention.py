"""GQA split-KV (flash-decoding) decode attention: CUDA kernel wrappers and
their plain PyTorch versions.

Ports ``repro/kernels/decode_attention/decode_attention.py``: the dense
``decode_attention`` (Pallas ``_decode_kernel``) and the paged
``paged_decode_attention`` (``_paged_decode_kernel``), plus the
``combine_partials`` log-sum-exp merge both feed.  One hand-written CUDA
kernel (``csrc/decode_attention.cu``) serves both: a block per
(batch, kv head, split, tile of 16 query heads of the group) walks its
split's rows with an fp32 online softmax and writes (acc, m, l) partials,
which ``combine_partials`` merges in fp32.

Splits divide each slot's live length, not the table: slot b has
``n_b = cdiv(min(len_b, extent), bkv)`` live KV blocks, and split ``sp``
walks blocks ``[sp * c_b, min(n_b, (sp + 1) * c_b))`` with
``c_b = cdiv(n_b, splits)`` (``split_range``).  A split with no block
writes ``m = -1e30, l = 0, acc = 0``.

Dispatch rule of every wrapper here: tensors on the CPU take the plain
PyTorch version; CUDA tensors launch the kernel or raise.  There is no
fallback from the card to the plain version.  ``<wrapper>.launches``
counts kernel launches; ``<plain>.calls`` counts plain-version calls.

The plain versions follow the kernel's split decomposition (same
splits, same masks, an fp32 online-softmax update per KV block where the
kernel makes one per staged step of rows), and the paged
and dense plain versions build identical per-block tensors, so with equal
``splits`` and ``bkv == page_size`` they are bitwise equal to each other
(on the CPU) just as the two kernel modes are on the card.
"""
from __future__ import annotations

import ctypes
import pathlib

import torch

from repro_torch.kernels.common import NEG_INF, cdiv, load_library, refuse_grad

_SOURCE = pathlib.Path(__file__).parent / "csrc" / "decode_attention.cu"
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MAX_SMEM = 232448        # a block's dynamic shared memory on sm_90
_MAX_D = 256
MAX_GROUP = 64            # at most four group tiles re-read each K/V tile
GROUP_TILE = 16           # query rows of the group one block takes
STAGES = 2                # depth of the kernel's cp.async ring
STEP_ROWS = {torch.float32: 32, torch.bfloat16: 64}   # K/V rows a step


def combine_partials(acc: torch.Tensor, m: torch.Tensor,
                     l: torch.Tensor) -> torch.Tensor:
    """Log-sum-exp merge of split partials: acc (b, hq, splits, d),
    m/l (b, hq, splits) -> (b, hq, d) fp32.  The ``max(l, 1e-30)`` guard
    turns a slot with no valid position into 0."""
    m_glob = m.amax(dim=-1, keepdim=True)
    w = torch.exp(m - m_glob)
    l_glob = (l * w).sum(dim=-1)
    num = (acc * w[..., None]).sum(dim=2)
    return num / l_glob.clamp_min(1e-30)[..., None]


# ---------------------------------------------------------------------------
# Plain PyTorch versions (the CPU path, and the kernel's yardstick on the card)
# ---------------------------------------------------------------------------

def split_range(lengths, extent: int, bkv: int, splits: int):
    """Each slot's live-length split rule, (b,) int64 tensors ``(n, c)``:
    slot b has ``n = cdiv(min(len_b, extent), bkv)`` live KV blocks and
    split ``sp`` walks blocks ``[sp * c, min(n, (sp + 1) * c))`` with
    ``c = cdiv(n, splits)``.  A split past ``n`` has no block.  The kernel
    computes the same from ``lengths`` on the device."""
    lens = lengths.to(torch.int64).clamp(0, extent)
    n = (lens + bkv - 1) // bkv
    return n, (n + splits - 1) // splits


def _split_kv_plain(q, load_rows, lengths, hkv, splits, bkv, extent, scale):
    """fp32 online softmax over each split's live blocks, every split at
    once, one KV block a step (the kernel's split rule, ``split_range``).

    ``load_rows(blk)`` returns the (b, hkv, splits, bkv, d) K and V of the
    (b, splits) logical block indices ``blk`` (clamped into the table).
    Lanes past a slot's length or its split's last block are zeroed and
    get an explicit zero probability: a wholly masked step has m_cur ==
    m_prev, where a bare exp(s - m_cur) would be 1, and no value there (an
    unmapped page's, say) reaches the output."""
    b, hq, d = q.shape
    group = hq // hkv
    dev = q.device
    qf = q.float().reshape(b, hkv, 1, group, d)
    acc = torch.zeros(b, hkv, splits, group, d, device=dev)
    m = torch.full((b, hkv, splits, group), NEG_INF, device=dev)
    l = torch.zeros(b, hkv, splits, group, device=dev)
    lens = lengths.to(device=dev, dtype=torch.int64).clamp(0, extent)
    n_blk, per = split_range(lens, extent, bkv, splits)
    first = torch.arange(splits, device=dev)[None, :] * per[:, None]
    lane = torch.arange(bkv, device=dev)
    # Every step runs (no host sync to find the longest split).
    for ik in range(cdiv(cdiv(extent, bkv), splits)):
        blk = first + ik                                          # (b, splits)
        pos = blk[..., None] * bkv + lane                         # (b, sp, bkv)
        ok = (ik < per)[:, None, None] & (pos < lens[:, None, None])
        k_blk, v_blk = load_rows(blk.clamp(0, cdiv(extent, bkv) - 1))
        keep = ok[:, None, :, :, None]
        k_blk = torch.where(keep, k_blk.float(), 0.0)
        v_blk = torch.where(keep, v_blk.float(), 0.0)
        mask = ok[:, None, :, None, :]                            # (b,1,sp,1,bkv)
        s = torch.matmul(qf, k_blk.transpose(-1, -2)) * scale     # (b,h,sp,g,bkv)
        s = torch.where(mask, s, NEG_INF)
        m_cur = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_cur)
        p = torch.where(mask, torch.exp(s - m_cur[..., None]), 0.0)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.matmul(p, v_blk)
        m = m_cur
    # (b, hkv, splits, group, .) -> (b, hq, splits, .)
    acc = acc.permute(0, 1, 3, 2, 4).reshape(b, hq, splits, d)
    m = m.permute(0, 1, 3, 2).reshape(b, hq, splits)
    l = l.permute(0, 1, 3, 2).reshape(b, hq, splits)
    return acc, m, l


def _dense_geometry(s: int, bkv: int) -> int:
    """The dense mode's KV block: ``bkv`` capped at the view's width."""
    return max(1, min(int(bkv), s))


def _paged_geometry(n_table: int, splits: int) -> int:
    """The paged mode's split count: at most one split per table page."""
    return max(1, min(int(splits), n_table))


def _dense_partials_plain(q, k, v, lengths, scale, bkv, splits):
    b, hq, d = q.shape
    _, hkv, s, _ = k.shape
    scale = float(scale if scale is not None else d ** -0.5)
    if lengths is None:
        lengths = torch.full((b,), s, dtype=torch.int32, device=q.device)
    bkv = _dense_geometry(s, bkv)
    lane = torch.arange(bkv, device=q.device)
    slot = torch.arange(b, device=q.device)[:, None, None]

    def load_rows(blk):
        pos = (blk[..., None] * bkv + lane).clamp_max(s - 1)     # (b, sp, bkv)
        return (k[slot, :, pos].permute(0, 3, 1, 2, 4),
                v[slot, :, pos].permute(0, 3, 1, 2, 4))

    return _split_kv_plain(q, load_rows, lengths, hkv, splits, bkv, s, scale)


def decode_attention_plain(q, k, v, lengths=None, *, scale=None, bkv=512,
                           splits=1):
    """Plain version of :func:`decode_attention` (q (b, hq, d); k/v
    (b, hkv, s, d), any strides)."""
    decode_attention_plain.calls += 1
    acc, m, l = _dense_partials_plain(q, k, v, lengths, scale, bkv, splits)
    return combine_partials(acc, m, l).to(q.dtype)


decode_attention_plain.calls = 0


def decode_attention_partials_plain(q, k, v, lengths=None, *, scale=None,
                                    bkv=512, splits=1):
    """Plain version of :func:`decode_attention_partials` (counted in
    ``decode_attention_plain.calls``)."""
    decode_attention_plain.calls += 1
    return _dense_partials_plain(q, k, v, lengths, scale, bkv, splits)


def paged_decode_attention_plain(q, k_pool, v_pool, pages, lengths=None, *,
                                 scale=None, splits=1):
    """Plain version of :func:`paged_decode_attention` (pools
    (N, page_size, hkv, d), pages (b, P) with -1 = unmapped)."""
    paged_decode_attention_plain.calls += 1
    b, hq, d = q.shape
    N, psz, hkv, _ = k_pool.shape
    P = pages.shape[1]
    scale = float(scale if scale is not None else d ** -0.5)
    if lengths is None:
        lengths = torch.full((b,), P * psz, dtype=torch.int32, device=q.device)
    splits = _paged_geometry(P, splits)
    pages = pages.to(q.device).long()
    slot = torch.arange(b, device=q.device)[:, None]

    def load_rows(blk):
        # Unmapped (-1) entries clamp to page 0; every lane they feed sits
        # at pos >= lengths and is zeroed.
        phys = pages[slot, blk].clamp(0, N - 1)                  # (b, splits)
        return (k_pool[phys].permute(0, 3, 1, 2, 4),
                v_pool[phys].permute(0, 3, 1, 2, 4))

    acc, m, l = _split_kv_plain(q, load_rows, lengths, hkv, splits, psz,
                                P * psz, scale)
    return combine_partials(acc, m, l).to(q.dtype)


paged_decode_attention_plain.calls = 0


# ---------------------------------------------------------------------------
# CUDA kernel launch
# ---------------------------------------------------------------------------

def _bind(lib) -> None:
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.split_kv_decode.argtypes = [
        i32, p, i64, i64, p, p, p, i64, i64, i64, i32, i32, i32, p,
        p, p, p, i32, i32, i32, i32, i32, i32, i32, ctypes.c_float, p,
    ]
    lib.split_kv_decode.restype = i32


_split_kv_decode = None


def _kernel():
    """The bound ``split_kv_decode`` C function: built and loaded on first
    use, then kept in this module, so a launch takes no lock."""
    global _split_kv_decode
    if _split_kv_decode is None:
        _split_kv_decode = load_library(_SOURCE, _bind).split_kv_decode
    return _split_kv_decode


def _all_cpu(*tensors) -> bool:
    return all(t is None or t.device.type == "cpu" for t in tensors)


def smem_bytes(dtype, d: int) -> int:
    """Dynamic shared memory of one block (the kernel's layout): a
    ``STAGES``-deep ring of K and V tiles of ``rows`` rows, each row padded
    by 16 bytes, and of their row offsets; the group tile's fp32 query
    rows and its scores."""
    es = torch.empty((), dtype=dtype).element_size()
    rows = STEP_ROWS[dtype]
    row_bytes = cdiv(d * es, 16) * 16
    return (STAGES * 2 * rows * (row_bytes + 16) + 8 * STAGES * rows
            + 4 * GROUP_TILE * (row_bytes // es + rows + 1))


def _check_inputs(name, q, k, v, pages, lengths, group, d):
    """Raise ValueError naming what the kernel does not take.  Never routes
    anything to the plain version."""
    if q.dim() != 3:
        raise ValueError(f"{name}: q must be (b, hq, d), got {tuple(q.shape)}")
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"{name}: dtype {q.dtype} not supported "
                         f"(takes {sorted(map(str, _DTYPE_CODE))})")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{name}: q/k/v dtypes differ: "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if k.shape != v.shape or k.stride() != v.stride():
        raise ValueError(f"{name}: k and v must share shape and strides")
    if q.stride(-1) != 1 or k.stride(-1) != 1:
        raise ValueError(f"{name}: the head dim of q, k and v must be "
                         "contiguous (stride 1)")
    if group > MAX_GROUP or d > _MAX_D:
        raise ValueError(f"{name}: group {group} > {MAX_GROUP} or head dim "
                         f"{d} > {_MAX_D} is beyond the kernel's tiles")
    if smem_bytes(q.dtype, d) > _MAX_SMEM:
        raise ValueError(f"{name}: head dim {d} needs "
                         f"{smem_bytes(q.dtype, d)} bytes of shared memory, "
                         f"more than {_MAX_SMEM}")
    es = q.element_size()
    if (d * es % 16 or any(st * es % 16 for st in k.stride()[:3])
            or k.data_ptr() % 16 or v.data_ptr() % 16):
        raise ValueError(f"{name}: every row of k and v must be 16-byte "
                         f"aligned (head dim {d} x {es} bytes, strides "
                         f"{k.stride()[:3]})")
    for label, t in (("lengths", lengths), ("pages", pages)):
        if t is not None and (t.dtype != torch.int32 or not t.is_contiguous()):
            raise ValueError(f"{name}: {label} must be contiguous int32, got "
                             f"{t.dtype} (contiguous={t.is_contiguous()})")
    tensors = [t for t in (q, k, v, pages, lengths) if t is not None]
    if any(t.device.type != "cuda" for t in tensors):
        raise ValueError(f"{name}: the CUDA kernel takes CUDA tensors only, "
                         f"got devices {[str(t.device) for t in tensors]}")
    if len({t.device for t in tensors}) != 1:
        raise ValueError(f"{name}: tensors on more than one device")


def _launch(q, k, v, kv_strides, pages, psz, n_table, n_pages, lengths,
            hkv, splits, bkv, extent, scale):
    b, hq, d = q.shape
    acc = torch.empty((b, hq, splits, d), dtype=torch.float32, device=q.device)
    m = torch.empty((b, hq, splits), dtype=torch.float32, device=q.device)
    l = torch.empty((b, hq, splits), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _kernel()(
        _DTYPE_CODE[q.dtype], q.data_ptr(), q.stride(0), q.stride(1),
        k.data_ptr(), v.data_ptr(), pages.data_ptr() if pages is not None
        else None, *kv_strides, psz, n_table, n_pages, lengths.data_ptr(),
        acc.data_ptr(), m.data_ptr(), l.data_ptr(), b, hkv, hq // hkv, d,
        splits, bkv, extent, scale, stream,
    )
    if err != 0:
        raise RuntimeError(f"split_kv_decode launch failed: CUDA error {err}")
    return acc, m, l


def _dense_partials_cuda(q, k, v, lengths, scale, bkv, splits):
    refuse_grad("decode_attention", q, k, v)
    b, hq, d = q.shape
    _, hkv, s, _ = k.shape
    if hq % hkv:
        raise ValueError(f"decode_attention: hq {hq} % hkv {hkv} != 0")
    bkv = _dense_geometry(s, bkv)
    splits = max(1, int(splits))
    if lengths is None:
        lengths = torch.full((b,), s, dtype=torch.int32, device=q.device)
    _check_inputs("decode_attention", q, k, v, None, lengths, hq // hkv, d)
    scale = float(scale if scale is not None else d ** -0.5)
    return _launch(q, k, v, (k.stride(0), k.stride(1), k.stride(2)),
                   None, 1, 0, 0, lengths, hkv, splits, bkv, s, scale)


def decode_attention_cuda(q, k, v, lengths=None, *, scale=None, bkv=512,
                          splits=1):
    """The CUDA kernel over a dense (b, hkv, s, d) view (any strides with a
    contiguous head dim).  CUDA tensors only."""
    acc, m, l = _dense_partials_cuda(q, k, v, lengths, scale, bkv, splits)
    decode_attention.launches += 1
    return combine_partials(acc, m, l).to(q.dtype)


def decode_attention_partials_cuda(q, k, v, lengths=None, *, scale=None,
                                   bkv=512, splits=1):
    """The CUDA kernel's partials before ``combine_partials`` (counted in
    ``decode_attention.launches``).  CUDA tensors only."""
    out = _dense_partials_cuda(q, k, v, lengths, scale, bkv, splits)
    decode_attention.launches += 1
    return out


def paged_decode_attention_cuda(q, k_pool, v_pool, pages, lengths=None, *,
                                scale=None, splits=1):
    """The CUDA kernel reading an (N, page_size, hkv, d) pool in place
    through a (b, P) int32 page table.  CUDA tensors only."""
    refuse_grad("paged_decode_attention", q, k_pool, v_pool)
    b, hq, d = q.shape
    N, psz, hkv, _ = k_pool.shape
    P = pages.shape[1]
    if hq % hkv:
        raise ValueError(f"paged_decode_attention: hq {hq} % hkv {hkv} != 0")
    splits = _paged_geometry(P, splits)
    if lengths is None:
        lengths = torch.full((b,), P * psz, dtype=torch.int32, device=q.device)
    _check_inputs("paged_decode_attention", q, k_pool, v_pool, pages,
                  lengths, hq // hkv, d)
    scale = float(scale if scale is not None else d ** -0.5)
    acc, m, l = _launch(
        q, k_pool, v_pool,
        (k_pool.stride(0), k_pool.stride(1), k_pool.stride(2)),
        pages, psz, P, N, lengths, hkv, splits, psz, P * psz, scale,
    )
    paged_decode_attention.launches += 1
    return combine_partials(acc, m, l).to(q.dtype)


# ---------------------------------------------------------------------------
# Public wrappers: CPU tensors -> plain version, CUDA tensors -> kernel.
# ---------------------------------------------------------------------------

def decode_attention(q, k, v, lengths=None, *, scale=None, bkv=512,
                     splits=1):
    """Split-KV decode attention over a dense view: q (b, hq, d), k/v
    (b, hkv, s, d), lengths (b,) int32 -> (b, hq, d) in q's dtype."""
    if _all_cpu(q, k, v, lengths):
        return decode_attention_plain(q, k, v, lengths, scale=scale, bkv=bkv,
                                      splits=splits)
    return decode_attention_cuda(q, k, v, lengths, scale=scale, bkv=bkv,
                                 splits=splits)


decode_attention.launches = 0


def decode_attention_partials(q, k, v, lengths=None, *, scale=None, bkv=512,
                              splits=1):
    """The split partials of :func:`decode_attention`, unmerged: acc
    (b, hq, splits, d) unnormalised, m and l (b, hq, splits), all fp32.  A
    split with no live position has m = -1e30, l = 0 and acc = 0.  A launch
    counts in ``decode_attention.launches``."""
    if _all_cpu(q, k, v, lengths):
        return decode_attention_partials_plain(q, k, v, lengths, scale=scale,
                                               bkv=bkv, splits=splits)
    return decode_attention_partials_cuda(q, k, v, lengths, scale=scale,
                                          bkv=bkv, splits=splits)


def paged_decode_attention(q, k_pool, v_pool, pages, lengths=None, *,
                           scale=None, splits=1):
    """Split-KV decode attention read in place from a page pool: q
    (b, hq, d), pools (N, page_size, hkv, d), pages (b, P) int32 (-1 =
    unmapped), lengths (b,) int32 -> (b, hq, d) in q's dtype."""
    if _all_cpu(q, k_pool, v_pool, pages, lengths):
        return paged_decode_attention_plain(q, k_pool, v_pool, pages, lengths,
                                            scale=scale, splits=splits)
    return paged_decode_attention_cuda(q, k_pool, v_pool, pages, lengths,
                                       scale=scale, splits=splits)


paged_decode_attention.launches = 0


def reset_counters() -> None:
    """Zero every launch and plain-call counter of this module."""
    decode_attention.launches = 0
    paged_decode_attention.launches = 0
    decode_attention_plain.calls = 0
    paged_decode_attention_plain.calls = 0
