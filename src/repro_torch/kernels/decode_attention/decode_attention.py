"""GQA split-KV (flash-decoding) decode attention: CUDA kernel wrappers and
their plain PyTorch versions.

Ports ``repro/kernels/decode_attention/decode_attention.py``: the dense
``decode_attention`` (Pallas ``_decode_kernel``) and the paged
``paged_decode_attention`` (``_paged_decode_kernel``), plus the
``combine_partials`` log-sum-exp merge both feed.  One hand-written CUDA
kernel (``csrc/decode_attention.cu``) serves both: a block per
(batch, kv head, split) loops over its split's KV blocks with an fp32
online softmax and writes (acc, m, l) partials, which ``combine_partials``
merges in fp32.

Dispatch rule of every wrapper here: tensors on the CPU take the plain
PyTorch version; CUDA tensors launch the kernel or raise.  There is no
fallback from the card to the plain version.  ``<wrapper>.launches``
counts kernel launches; ``<plain>.calls`` counts plain-version calls.

The plain versions follow the kernel's split and block decomposition
(same masks, same fp32 online-softmax update per KV block), and the paged
and dense plain versions build identical per-block tensors, so with equal
``splits`` and ``bkv == page_size`` they are bitwise equal to each other
(on the CPU) just as the two kernel modes are on the card.
"""
from __future__ import annotations

import ctypes
import pathlib

import torch

from repro_torch.kernels.common import NEG_INF, cdiv, load_library

_SOURCE = pathlib.Path(__file__).parent / "csrc" / "decode_attention.cu"
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MAX_SMEM = 48 * 1024     # static launch limit; the kernel asks no opt-in


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

def _split_kv_plain(q, load_block, lengths, hkv, splits, steps, bkv, scale):
    """fp32 online softmax over ``steps`` KV blocks for every split at once.

    ``load_block(ik)`` returns the (b, hkv, splits, bkv, d) fp32 K and V of
    step ``ik`` of every split.  Masked lanes get an explicit zero
    probability: a wholly masked block has m_cur == m_prev == NEG_INF, where
    a bare exp(s - m_cur) would be 1."""
    b, hq, d = q.shape
    group = hq // hkv
    dev = q.device
    qf = q.float().reshape(b, hkv, 1, group, d)
    acc = torch.zeros(b, hkv, splits, group, d, device=dev)
    m = torch.full((b, hkv, splits, group), NEG_INF, device=dev)
    l = torch.zeros(b, hkv, splits, group, device=dev)
    lens = lengths.to(device=dev, dtype=torch.int64)
    split_base = torch.arange(splits, device=dev) * steps
    lane = torch.arange(bkv, device=dev)
    for ik in range(steps):
        k_blk, v_blk = load_block(ik)
        pos = (split_base + ik)[:, None] * bkv + lane[None, :]   # (splits, bkv)
        mask = (pos[None] < lens[:, None, None])[:, None, :, None, :]
        s = torch.matmul(qf, k_blk.transpose(-1, -2)) * scale    # (b,h,sp,g,bkv)
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


def _dense_geometry(s: int, bkv: int, splits: int) -> tuple[int, int]:
    """(bkv, kv_steps) of the dense decomposition: ``s`` padded to
    splits * kv_steps * bkv, as the Pallas kernel pads it."""
    bkv = min(bkv, s)
    return bkv, cdiv(cdiv(s, splits), bkv)


def _paged_geometry(n_table: int, splits: int) -> tuple[int, int]:
    """(splits, page_steps): one KV block per logical page."""
    splits = max(1, min(int(splits), n_table))
    return splits, cdiv(n_table, splits)


def decode_attention_plain(q, k, v, lengths=None, *, scale=None, bkv=512,
                           splits=1):
    """Plain version of :func:`decode_attention` (q (b, hq, d); k/v
    (b, hkv, s, d), any strides)."""
    decode_attention_plain.calls += 1
    b, hq, d = q.shape
    _, hkv, s, _ = k.shape
    scale = float(scale if scale is not None else d ** -0.5)
    if lengths is None:
        lengths = torch.full((b,), s, dtype=torch.int32, device=q.device)
    bkv, steps = _dense_geometry(s, bkv, splits)
    s_pad = splits * steps * bkv
    if s_pad != s:
        pad = (0, 0, 0, s_pad - s)
        k = torch.nn.functional.pad(k, pad)
        v = torch.nn.functional.pad(v, pad)
    kb = k.reshape(b, hkv, splits, steps, bkv, d)
    vb = v.reshape(b, hkv, splits, steps, bkv, d)

    def load_block(ik):
        return (kb[:, :, :, ik].to(torch.float32).contiguous(),
                vb[:, :, :, ik].to(torch.float32).contiguous())

    acc, m, l = _split_kv_plain(q, load_block, lengths, hkv, splits, steps,
                                bkv, scale)
    return combine_partials(acc, m, l).to(q.dtype)


decode_attention_plain.calls = 0


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
    splits, steps = _paged_geometry(P, splits)
    split_base = torch.arange(splits, device=q.device) * steps
    pages = pages.to(q.device).long()

    def load_block(ik):
        # Grid overrun past P clamps to P - 1 and unmapped (-1) entries to
        # page 0; every lane they feed sits at pos >= lengths and is masked.
        lp = (split_base + ik).clamp_max(P - 1)
        phys = pages[:, lp].clamp(0, N - 1)                     # (b, splits)

        def blk(pool):
            return (pool[phys].permute(0, 3, 1, 2, 4)
                    .to(torch.float32).contiguous())

        return blk(k_pool), blk(v_pool)

    acc, m, l = _split_kv_plain(q, load_block, lengths, hkv, splits, steps,
                                psz, scale)
    return combine_partials(acc, m, l).to(q.dtype)


paged_decode_attention_plain.calls = 0


# ---------------------------------------------------------------------------
# CUDA kernel launch
# ---------------------------------------------------------------------------

def _bind(lib) -> None:
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.split_kv_decode.argtypes = [
        i32, p, i64, i64, p, p, p, i64, i64, i64, i32, i32, i32, p,
        p, p, p, i32, i32, i32, i32, i32, i32, i32, i32, ctypes.c_float, p,
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


def _check_inputs(name, q, k, v, pages, lengths, group, d, bkv):
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
    if group > 16 or d > 256:
        raise ValueError(f"{name}: group {group} > 16 or head dim {d} > 256 "
                         "is beyond the kernel's register tiles")
    if 4 * group * (d + bkv) + 8 * bkv > _MAX_SMEM:
        raise ValueError(f"{name}: group {group} x (d {d} + bkv {bkv}) fp32 "
                         f"and {bkv} row offsets exceed {_MAX_SMEM} bytes of "
                         "shared memory")
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
            hkv, splits, steps, bkv, extent, scale):
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
        splits, steps, bkv, extent, scale, stream,
    )
    if err != 0:
        raise RuntimeError(f"split_kv_decode launch failed: CUDA error {err}")
    return acc, m, l


def decode_attention_cuda(q, k, v, lengths=None, *, scale=None, bkv=512,
                          splits=1):
    """The CUDA kernel over a dense (b, hkv, s, d) view (any strides with a
    contiguous head dim).  CUDA tensors only."""
    b, hq, d = q.shape
    _, hkv, s, _ = k.shape
    if hq % hkv:
        raise ValueError(f"decode_attention: hq {hq} % hkv {hkv} != 0")
    bkv, steps = _dense_geometry(s, bkv, splits)
    if lengths is None:
        lengths = torch.full((b,), s, dtype=torch.int32, device=q.device)
    _check_inputs("decode_attention", q, k, v, None, lengths, hq // hkv, d,
                  bkv)
    scale = float(scale if scale is not None else d ** -0.5)
    acc, m, l = _launch(q, k, v, (k.stride(0), k.stride(1), k.stride(2)),
                        None, 1, 0, 0, lengths, hkv, splits, steps, bkv, s,
                        scale)
    decode_attention.launches += 1
    return combine_partials(acc, m, l).to(q.dtype)


def paged_decode_attention_cuda(q, k_pool, v_pool, pages, lengths=None, *,
                                scale=None, splits=1):
    """The CUDA kernel reading an (N, page_size, hkv, d) pool in place
    through a (b, P) int32 page table.  CUDA tensors only."""
    b, hq, d = q.shape
    N, psz, hkv, _ = k_pool.shape
    P = pages.shape[1]
    if hq % hkv:
        raise ValueError(f"paged_decode_attention: hq {hq} % hkv {hkv} != 0")
    splits, steps = _paged_geometry(P, splits)
    if lengths is None:
        lengths = torch.full((b,), P * psz, dtype=torch.int32, device=q.device)
    _check_inputs("paged_decode_attention", q, k_pool, v_pool, pages,
                  lengths, hq // hkv, d, psz)
    scale = float(scale if scale is not None else d ** -0.5)
    acc, m, l = _launch(
        q, k_pool, v_pool,
        (k_pool.stride(0), k_pool.stride(1), k_pool.stride(2)),
        pages, psz, P, N, lengths, hkv, splits, steps, psz, P * psz, scale,
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
