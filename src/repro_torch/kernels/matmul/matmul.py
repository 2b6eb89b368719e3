"""Policy-planned blocked matmul: the CUDA kernel's wrapper and its plain
PyTorch version.

Ports both Pallas kernels of ``repro/kernels/matmul/matmul.py`` with one
hand-written CUDA kernel (``csrc/matmul.cu``): ``_mm_kernel``, the
accumulating schedule (output ``RESIDENT_ACCUM``: an fp32 accumulator over
all of K, each output tile written once), and the inline split-K ``kern``
(output ``STREAM``: ``split_k`` ranges of K, each writing an fp32 partial
through to memory, then a sum and a cast).  How the schedule's knobs read
on the card:

* ``order`` (``"mnk"`` / ``"nmk"``) is the raster order in which CTAs walk
  the output tiles, row-major or column-major; the split-K schedule runs
  row-major whatever the order, as the reference's split path ignores it;
* ``bm x bn`` is the L2 window: the group of CTA tiles (128 x 128 in bf16,
  64 x 64 in fp32, the kernel's own) that the raster finishes before it
  moves to the next window;
* ``bk`` is the split granule: ``ks`` and the split count follow the
  reference's rule on K rounded up to a multiple of ``bk``
  (:func:`split_ranges`), so every split sums the Pallas kernel's K range.

One CTA sums a tile over its K range in a fixed order, so ``mnk`` and
``nmk`` are bitwise equal on the card, and so are repeated calls.  The
kernel masks ragged m, k and n itself: nothing is padded by copying.

* :func:`matmul_plain` is the oracle's math (``ref.py``), with the same
  fp32 partial sums over the same K ranges when ``split_k > 1``: the CPU
  path and the kernel's yardstick on the card.
* :func:`matmul_cuda` launches the kernel; CUDA tensors only.

Dispatch rule, as in every kernel package of the port: tensors on the CPU
take the plain version; CUDA tensors launch the kernel or raise.
``matmul.launches`` counts launches of the accumulating schedule,
``matmul.splitk_launches`` those of the split-K schedule;
``matmul_plain.calls`` counts plain-version calls.
"""
from __future__ import annotations

import ctypes
import pathlib

import torch

from repro_torch.kernels.common import cdiv, load_library
from repro_torch.kernels.matmul import ref

_SOURCE = pathlib.Path(__file__).parent / "csrc" / "matmul.cu"
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
CTA_TILE = {torch.bfloat16: 128, torch.float32: 64}   # the kernel's tile edge
_MAX_SPLITS = 65535            # launch grid's y
ORDERS = ("mnk", "nmk")


def split_ranges(k: int, bk: int, split_k: int) -> tuple[int, int]:
    """(ks, splits): K elements per split and the split count, computed as
    the reference's split path does on K padded to a multiple of ``bk``.
    Split ``s`` sums ``[s * ks, min(k, (s + 1) * ks))``, never empty."""
    kp = cdiv(k, bk) * bk
    ks = cdiv(kp, split_k * bk) * bk
    return ks, cdiv(kp, ks)


def matmul_plain(a, b, *, bk: int = 256, split_k: int = 1, out_dtype=None):
    """a (m, k) @ b (k, n) in ``out_dtype`` (default a's): the fp32 product,
    or with ``split_k > 1`` the sum of the fp32 partial products over the
    split-K schedule's K ranges."""
    matmul_plain.calls += 1
    out_dtype = out_dtype or a.dtype
    if split_k <= 1:
        return ref.matmul(a, b, out_dtype)
    ks, splits = split_ranges(a.shape[1], min(bk, a.shape[1]), split_k)
    parts = torch.stack([a[:, s * ks:(s + 1) * ks].float()
                         @ b[s * ks:(s + 1) * ks].float()
                         for s in range(splits)])
    return parts.sum(0).to(out_dtype)


matmul_plain.calls = 0


def _bind(lib) -> None:
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.matmul.argtypes = [i32, i32, p, i64, p, i64, p, i32, i32, i32,
                           i32, i32, i32, i32, i32, p]
    lib.matmul.restype = i32


_mm = None


def _kernel():
    """The bound ``matmul`` C function, built and loaded on first use."""
    global _mm
    if _mm is None:
        _mm = load_library(_SOURCE, _bind).matmul
    return _mm


def _check_inputs(a, b, out_dtype, order, blocks):
    """Raise ValueError naming what the kernel does not take."""
    name = "matmul"
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"{name}: a (m, k) and b (k, n) expected, got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    if min(*a.shape, b.shape[1]) < 1 or max(*a.shape, b.shape[1]) > 2**31 - 1:
        raise ValueError(f"{name}: dimensions out of the kernel's range, "
                         f"got a {tuple(a.shape)}, b {tuple(b.shape)}")
    if a.dtype not in _DTYPE_CODE or b.dtype != a.dtype:
        raise ValueError(f"{name}: a and b must share a dtype of "
                         f"{sorted(map(str, _DTYPE_CODE))}, got {a.dtype} "
                         f"and {b.dtype}")
    if out_dtype not in _DTYPE_CODE:
        raise ValueError(f"{name}: out_dtype must be one of "
                         f"{sorted(map(str, _DTYPE_CODE))}, got {out_dtype}")
    if a.stride(1) != 1 or b.stride(1) != 1:
        raise ValueError(f"{name}: the last axis of a and b must be "
                         "contiguous (stride 1)")
    if order not in ORDERS:
        raise ValueError(f"{name}: order must be one of {ORDERS}, got "
                         f"{order!r}")
    if min(blocks) < 1:
        raise ValueError(f"{name}: bm, bn, bk and split_k must be at least "
                         f"1, got {blocks}")
    if a.device.type != "cuda" or b.device.type != "cuda":
        raise ValueError(f"{name}: the CUDA kernel takes CUDA tensors only, "
                         f"got devices {a.device} and {b.device}")
    if a.device != b.device:
        raise ValueError(f"{name}: tensors on more than one device")


def matmul_cuda(a, b, *, bm: int = 256, bn: int = 256, bk: int = 256,
                order: str = "mnk", split_k: int = 1, out_dtype=None):
    """The CUDA kernel; CUDA tensors only.  a and b may be strided along
    their rows (last axis contiguous); the result is contiguous."""
    out_dtype = out_dtype or a.dtype
    _check_inputs(a, b, out_dtype, order, (bm, bn, bk, split_k))
    m, k = a.shape
    n = b.shape[1]
    bm, bn, bk = min(bm, m), min(bn, n), min(bk, k)
    tile = CTA_TILE[a.dtype]
    win_m, win_n = max(1, bm // tile), max(1, bn // tile)
    if split_k > 1:
        ks, splits = split_ranges(k, bk, split_k)
        if splits > _MAX_SPLITS:
            raise ValueError(f"matmul: {splits} splits, more than the "
                             f"kernel's {_MAX_SPLITS}")
        out = torch.empty((splits, m, n), dtype=torch.float32,
                          device=a.device)
        col_major, code = 0, 0
    else:
        ks, splits = k, 1
        out = torch.empty((m, n), dtype=out_dtype, device=a.device)
        col_major, code = int(order == "nmk"), _DTYPE_CODE[out_dtype]
    stream = torch.cuda.current_stream(a.device).cuda_stream
    err = _kernel()(
        _DTYPE_CODE[a.dtype], code, a.data_ptr(), a.stride(0), b.data_ptr(),
        b.stride(0), out.data_ptr(), m, k, n, splits, ks, win_m, win_n,
        col_major, stream,
    )
    if err != 0:
        raise RuntimeError(f"matmul launch failed: CUDA error {err}")
    if split_k > 1:
        matmul.splitk_launches += 1
        return out.sum(0).to(out_dtype)
    matmul.launches += 1
    return out


def matmul(a, b, *, bm: int = 256, bn: int = 256, bk: int = 256,
           order: str = "mnk", split_k: int = 1, out_dtype=None):
    """a @ b under the given schedule: CPU tensors -> the plain version,
    CUDA tensors -> the kernel."""
    if a.device.type == "cpu" and b.device.type == "cpu":
        return matmul_plain(a, b, bk=bk, split_k=split_k,
                            out_dtype=out_dtype)
    return matmul_cuda(a, b, bm=bm, bn=bn, bk=bk, order=order,
                       split_k=split_k, out_dtype=out_dtype)


matmul.launches = 0
matmul.splitk_launches = 0


def reset_counters() -> None:
    """Zero the launch and plain-call counters of this module."""
    matmul.launches = 0
    matmul.splitk_launches = 0
    matmul_plain.calls = 0
