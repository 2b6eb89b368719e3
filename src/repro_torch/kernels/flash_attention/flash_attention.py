"""Causal / full GQA flash attention: CUDA kernel wrappers and their plain
PyTorch versions.  The port's prefill attention.

Ports ``repro/kernels/flash_attention/flash_attention.py`` (Pallas
``_flash_kernel``) with one hand-written CUDA source
(``csrc/flash_attention.cu``): a block per (q tile of 64 rows, q head,
batch) runs an fp32 online softmax over K/V tiles staged in shared
memory.  bf16 with a head dim up to 128 and 16-byte aligned rows takes
the tensor-core body (``mma.sync``, see :func:`body`); fp32 and the other
bf16 shapes the CUDA-core body.  Beside the
Pallas kernel's arguments (``q (b, hq, sq, d)``, ``k/v (b, hkv, skv, d)``,
``causal``, ``scale``, ``q_offset``) it takes what the serve path needs,
per slot:

* ``q_offset`` as an int or a (b,) int32 tensor: query row i of slot b
  sits at position ``q_offset[b] + i``;
* ``kv_len`` (b,) int32: keys at or past it are masked;
* ``q_len`` (b,) int32: query rows at or past it are padding and come out
  as zeros (a parked slot has ``q_len = 0``).

Two wrappers share the kernel: :func:`flash_attention` over dense K/V by
strides, and :func:`paged_flash_attention` reading an
``(N, page_size, hkv, d)`` pool in place through a (b, P) page table
(-1 = unmapped).  They are bitwise equal on the card when the dense K/V
is the gathered page view, and so are their plain versions on the CPU.

Dispatch rule, as in every kernel package of the port: tensors on the CPU
take the plain version; CUDA tensors launch the kernel or raise.
``<wrapper>.launches`` counts kernel launches; ``<plain>.calls`` counts
plain-version calls.
"""
from __future__ import annotations

import ctypes
import pathlib

import torch

from repro_torch.kernels.common import (
    NEG_INF, gather_pages, load_library, refuse_grad)

_SOURCE = pathlib.Path(__file__).parent / "csrc" / "flash_attention.cu"
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MAX_D = 256
PLAIN_BKV = 256      # KV block of the plain version's online softmax


def _per_slot(x, b: int, default: int, device) -> torch.Tensor:
    """An int or a (b,) tensor (None -> ``default``) as a (b,) int64."""
    if x is None:
        x = default
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.int64).expand(b)
    return torch.full((b,), int(x), dtype=torch.int64, device=device)


# ---------------------------------------------------------------------------
# Plain PyTorch versions (the CPU path, and the kernel's yardstick on the card)
# ---------------------------------------------------------------------------

def _flash_plain(q, k, v, causal, scale, q_offset, kv_len, q_len):
    """fp32 online softmax over KV blocks of ``PLAIN_BKV`` with the
    kernel's masks: key j of slot b is valid for row i iff j < kv_len[b]
    (and j <= q_offset[b] + i when causal); rows i >= q_len[b] are 0.
    Keys past kv_len are zeroed before use, so no value there (an
    unmapped page's, say) reaches the output."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    group = hq // hkv
    dev = q.device
    scale = float(scale if scale is not None else d ** -0.5)
    off = _per_slot(q_offset, b, 0, dev)
    kvl = _per_slot(kv_len, b, skv, dev).clamp(0, skv)
    ql = _per_slot(q_len, b, sq, dev).clamp(0, sq)
    rows = torch.arange(sq, device=dev)
    qpos = off[:, None] + rows[None, :]                        # (b, sq)
    row_ok = rows[None, :] < ql[:, None]                       # (b, sq)
    qf = q.float().reshape(b, hkv, group, sq, d)
    m = torch.full((b, hkv, group, sq), NEG_INF, device=dev)
    l = torch.zeros((b, hkv, group, sq), device=dev)
    acc = torch.zeros((b, hkv, group, sq, d), device=dev)
    # Every block runs (no host sync to find the last needed one): a block
    # with no valid pair leaves (acc, m, l) exactly as they were.
    for j0 in range(0, skv, PLAIN_BKV):
        kpos = j0 + torch.arange(min(PLAIN_BKV, skv - j0), device=dev)
        key_ok = kpos[None, :] < kvl[:, None]                  # (b, n)
        kb = torch.where(key_ok[:, None, :, None],
                         k[:, :, j0:j0 + kpos.numel()].float(), 0.0)
        vb = torch.where(key_ok[:, None, :, None],
                         v[:, :, j0:j0 + kpos.numel()].float(), 0.0)
        mask = key_ok[:, None, :] & row_ok[:, :, None]         # (b, sq, n)
        if causal:
            mask = mask & (kpos[None, None, :] <= qpos[:, :, None])
        mask = mask[:, None, None]
        s = torch.einsum("bhgqd,bhkd->bhgqk", qf, kb) * scale
        s = torch.where(mask, s, NEG_INF)
        m_cur = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_cur)
        p = torch.where(mask, torch.exp(s - m_cur[..., None]), 0.0)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bhgqk,bhkd->bhgqd", p, vb)
        m = m_cur
    out = acc / l.clamp_min(1e-30)[..., None]
    out = torch.where(row_ok[:, None, None, :, None], out, 0.0)
    return out.reshape(b, hq, sq, d).to(q.dtype)


def flash_attention_plain(q, k, v, *, causal=True, scale=None, q_offset=0,
                          kv_len=None, q_len=None):
    """Plain version of :func:`flash_attention`."""
    flash_attention_plain.calls += 1
    return _flash_plain(q, k, v, causal, scale, q_offset, kv_len, q_len)


flash_attention_plain.calls = 0


def paged_flash_attention_plain(q, k_pool, v_pool, pages, *, causal=True,
                                scale=None, q_offset=0, kv_len=None,
                                q_len=None):
    """Plain version of :func:`paged_flash_attention`: the dense plain
    version over the gathered page view."""
    paged_flash_attention_plain.calls += 1
    return _flash_plain(q, gather_pages(k_pool, pages).transpose(1, 2),
                        gather_pages(v_pool, pages).transpose(1, 2), causal,
                        scale, q_offset, kv_len, q_len)


paged_flash_attention_plain.calls = 0


# ---------------------------------------------------------------------------
# CUDA kernel launch
# ---------------------------------------------------------------------------

def _bind(lib) -> None:
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.flash_attention.argtypes = [
        i32, p, i64, i64, i64, p, i64, i64, i64, p, p, p, i64, i64, i64,
        i32, i32, i32, p, p, p, i32, i32, i32, i32, i32, i32,
        ctypes.c_float, i32, p,
    ]
    lib.flash_attention.restype = i32
    lib.flash_attention_body.argtypes = [
        i32, p, i64, i64, i64, p, i64, i64, i64, p, p, i64, i64, i64, i32,
    ]
    lib.flash_attention_body.restype = i32


_flash = None


def _kernel():
    """The bound ``flash_attention`` C function, built and loaded on first
    use, then kept in this module."""
    global _flash
    if _flash is None:
        _flash = load_library(_SOURCE, _bind).flash_attention
    return _flash


def body(q, k, v) -> str:
    """Which device body the kernel runs for these CUDA tensors (k/v dense
    (b, hkv, skv, d) or pools (N, page_size, hkv, d): the strides it reads
    are the first three either way): ``"mma"`` (bf16 on the tensor cores)
    or ``"cuda_cores"``.  The rule is the library's own."""
    fn = load_library(_SOURCE, _bind).flash_attention_body
    return "mma" if fn(
        _DTYPE_CODE[q.dtype], q.data_ptr(), q.stride(0), q.stride(1),
        q.stride(2), q.data_ptr(), q.stride(0), q.stride(1), q.stride(2),
        k.data_ptr(), v.data_ptr(), k.stride(0), k.stride(1), k.stride(2),
        q.shape[-1]) else "cuda_cores"


def _slot_vector(name, label, x, b, default, device) -> torch.Tensor:
    """A per-slot argument as the (b,) contiguous int32 device tensor the
    kernel reads; an int (or None -> ``default``) is broadcast."""
    if x is None:
        x = default
    if not isinstance(x, torch.Tensor):
        return torch.full((b,), int(x), dtype=torch.int32, device=device)
    if x.shape != (b,) or x.dtype != torch.int32 or not x.is_contiguous():
        raise ValueError(f"{name}: {label} must be a contiguous ({b},) int32 "
                         f"tensor, got {tuple(x.shape)} {x.dtype}")
    return x


def _check_inputs(name, q, k, v, pages):
    """Raise ValueError naming what the kernel does not take."""
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"{name}: q and k/v must be 4-D, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}")
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
    if q.shape[-1] > _MAX_D or k.shape[-1] != q.shape[-1]:
        raise ValueError(f"{name}: head dim {q.shape[-1]} must match k's "
                         f"and be at most {_MAX_D}")
    if pages is not None and (pages.dtype != torch.int32
                              or not pages.is_contiguous()):
        raise ValueError(f"{name}: pages must be contiguous int32, got "
                         f"{pages.dtype}")
    tensors = [t for t in (q, k, v, pages) if t is not None]
    if any(t.device.type != "cuda" for t in tensors):
        raise ValueError(f"{name}: the CUDA kernel takes CUDA tensors only, "
                         f"got devices {[str(t.device) for t in tensors]}")
    if len({t.device for t in tensors}) != 1:
        raise ValueError(f"{name}: tensors on more than one device")


def _launch(name, q, k, v, kv_strides, pages, psz, n_table, n_pages, hkv,
            skv, causal, scale, q_offset, kv_len, q_len):
    b, hq, sq, d = q.shape
    if hq % hkv:
        raise ValueError(f"{name}: hq {hq} % hkv {hkv} != 0")
    dev = q.device
    off = _slot_vector(name, "q_offset", q_offset, b, 0, dev)
    kvl = _slot_vector(name, "kv_len", kv_len, b, skv, dev)
    ql = _slot_vector(name, "q_len", q_len, b, sq, dev)
    if any(t.device != dev for t in (off, kvl, ql)):
        raise ValueError(f"{name}: per-slot vectors must be on {dev}")
    out = torch.empty_like(q)        # keeps q's strides (e.g. (b, s, h, d))
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _kernel()(
        _DTYPE_CODE[q.dtype], q.data_ptr(), q.stride(0), q.stride(1),
        q.stride(2), out.data_ptr(), out.stride(0), out.stride(1),
        out.stride(2), k.data_ptr(), v.data_ptr(),
        pages.data_ptr() if pages is not None else None, *kv_strides, psz,
        n_table, n_pages, off.data_ptr(), kvl.data_ptr(), ql.data_ptr(), b,
        hq, hkv, sq, skv, d,
        float(scale if scale is not None else d ** -0.5), int(causal),
        stream,
    )
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    return out


def flash_attention_cuda(q, k, v, *, causal=True, scale=None, q_offset=0,
                         kv_len=None, q_len=None):
    """The CUDA kernel over dense (b, hkv, skv, d) K/V (any strides with a
    contiguous head dim).  CUDA tensors only."""
    refuse_grad("flash_attention", q, k, v)
    _check_inputs("flash_attention", q, k, v, None)
    _, hkv, skv, _ = k.shape
    out = _launch("flash_attention", q, k, v,
                  (k.stride(0), k.stride(1), k.stride(2)), None, 1, 0, 0,
                  hkv, skv, causal, scale, q_offset, kv_len, q_len)
    flash_attention.launches += 1
    return out


def paged_flash_attention_cuda(q, k_pool, v_pool, pages, *, causal=True,
                               scale=None, q_offset=0, kv_len=None,
                               q_len=None):
    """The CUDA kernel reading an (N, page_size, hkv, d) pool in place
    through a (b, P) int32 page table.  CUDA tensors only."""
    refuse_grad("paged_flash_attention", q, k_pool, v_pool)
    _check_inputs("paged_flash_attention", q, k_pool, v_pool, pages)
    N, psz, hkv, _ = k_pool.shape
    P = pages.shape[1]
    if pages.shape[0] != q.shape[0]:
        raise ValueError("paged_flash_attention: pages must have one row "
                         "per slot")
    out = _launch("paged_flash_attention", q, k_pool, v_pool,
                  (k_pool.stride(0), k_pool.stride(1), k_pool.stride(2)),
                  pages, psz, P, N, hkv, P * psz, causal, scale, q_offset,
                  kv_len, q_len)
    paged_flash_attention.launches += 1
    return out


# ---------------------------------------------------------------------------
# Public wrappers: CPU tensors -> plain version, CUDA tensors -> kernel.
# ---------------------------------------------------------------------------

def _all_cpu(*xs) -> bool:
    return all(not isinstance(x, torch.Tensor) or x.device.type == "cpu"
               for x in xs)


def flash_attention(q, k, v, *, causal=True, scale=None, q_offset=0,
                    kv_len=None, q_len=None):
    """GQA flash attention over dense K/V: q (b, hq, sq, d), k/v
    (b, hkv, skv, d) -> (b, hq, sq, d) in q's dtype."""
    kw = dict(causal=causal, scale=scale, q_offset=q_offset, kv_len=kv_len,
              q_len=q_len)
    if _all_cpu(q, k, v, q_offset, kv_len, q_len):
        return flash_attention_plain(q, k, v, **kw)
    return flash_attention_cuda(q, k, v, **kw)


flash_attention.launches = 0


def paged_flash_attention(q, k_pool, v_pool, pages, *, causal=True,
                          scale=None, q_offset=0, kv_len=None, q_len=None):
    """GQA flash attention read in place from a page pool: q
    (b, hq, sq, d), pools (N, page_size, hkv, d), pages (b, P) int32
    (-1 = unmapped) -> (b, hq, sq, d) in q's dtype."""
    kw = dict(causal=causal, scale=scale, q_offset=q_offset, kv_len=kv_len,
              q_len=q_len)
    if _all_cpu(q, k_pool, v_pool, pages, q_offset, kv_len, q_len):
        return paged_flash_attention_plain(q, k_pool, v_pool, pages, **kw)
    return paged_flash_attention_cuda(q, k_pool, v_pool, pages, **kw)


paged_flash_attention.launches = 0


def reset_counters() -> None:
    """Zero every launch and plain-call counter of this module."""
    flash_attention.launches = 0
    paged_flash_attention.launches = 0
    flash_attention_plain.calls = 0
    paged_flash_attention_plain.calls = 0
