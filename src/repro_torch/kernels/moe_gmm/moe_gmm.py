"""MoE grouped expert GEMM: the CUDA kernel's wrapper and its plain PyTorch
version.

Ports ``repro/kernels/moe_gmm/moe_gmm.py`` (Pallas ``grouped_matmul``,
``_gmm_kernel``) with one hand-written CUDA kernel (``csrc/moe_gmm.cu``):
``y[e] = x[e] @ w[e]`` over per-expert capacity buffers, an fp32
accumulator, rows at or past ``counts[e]`` written as exact zeros and row
tiles wholly past ``counts[e]`` skipped.  bf16 inputs multiply on the
tensor cores (``wmma`` 16x16x16 fragments), fp32 inputs on the CUDA cores.
One block owns each output tile and sums over K in a fixed order (no
atomics, no split-K), so a call is bitwise reproducible, and a row's result
does not depend on what the other rows hold.

* :func:`grouped_matmul_plain` is the oracle's math (``ref.py``): the CPU
  path and the kernel's yardstick on the card.
* :func:`grouped_matmul_cuda` launches the kernel; CUDA tensors only.

Dispatch rule, as in every kernel package of the port: tensors on the CPU
take the plain version; CUDA tensors launch the kernel or raise.
``grouped_matmul.launches`` counts kernel launches;
``grouped_matmul_plain.calls`` counts plain-version calls.
"""
from __future__ import annotations

import ctypes
import pathlib

import torch

from repro_torch.kernels.common import load_library
from repro_torch.kernels.moe_gmm import ref

_SOURCE = pathlib.Path(__file__).parent / "csrc" / "moe_gmm.cu"
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MAX_GRID = 65535            # launch grid's y (row tiles) and z (experts)


def grouped_matmul_plain(x, w, counts=None, *, out_dtype=None):
    """x (e, c, k), w (e, k, n), counts (e,) or None -> (e, c, n) in
    ``out_dtype`` (default x's): fp32 einsum, rows past counts zeroed."""
    grouped_matmul_plain.calls += 1
    return ref.grouped_matmul(x, w, counts, out_dtype=out_dtype)


grouped_matmul_plain.calls = 0


def _bind(lib) -> None:
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.moe_gmm.argtypes = [i32, i32, p, i64, i64, p, i64, i64, p, p,
                            i32, i32, i32, i32, p]
    lib.moe_gmm.restype = i32


_gmm = None


def _kernel():
    """The bound ``moe_gmm`` C function, built and loaded on first use."""
    global _gmm
    if _gmm is None:
        _gmm = load_library(_SOURCE, _bind).moe_gmm
    return _gmm


def _check_inputs(x, w, counts, out_dtype):
    """Raise ValueError naming what the kernel does not take."""
    name = "grouped_matmul"
    if x.dim() != 3 or w.dim() != 3:
        raise ValueError(f"{name}: x (e, c, k) and w (e, k, n) expected, got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    e, c, k = x.shape
    if w.shape[0] != e or w.shape[1] != k:
        raise ValueError(f"{name}: shapes disagree: x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}")
    if min(e, c, k, w.shape[2]) < 1 or e > _MAX_GRID or \
            c > 64 * _MAX_GRID or max(k, w.shape[2]) > 2 ** 31 - 1:
        raise ValueError(f"{name}: dimensions out of the kernel's range "
                         f"(each at least 1, at most {_MAX_GRID} experts and "
                         f"{64 * _MAX_GRID} rows), got x {tuple(x.shape)}, "
                         f"w {tuple(w.shape)}")
    if x.dtype not in _DTYPE_CODE or w.dtype != x.dtype:
        raise ValueError(f"{name}: x and w must share a dtype of "
                         f"{sorted(map(str, _DTYPE_CODE))}, got {x.dtype} "
                         f"and {w.dtype}")
    if out_dtype not in _DTYPE_CODE:
        raise ValueError(f"{name}: out_dtype must be one of "
                         f"{sorted(map(str, _DTYPE_CODE))}, got {out_dtype}")
    if x.stride(2) != 1 or w.stride(2) != 1:
        raise ValueError(f"{name}: the last axis of x and w must be "
                         "contiguous (stride 1)")
    if counts is not None and (counts.dtype != torch.int32
                               or tuple(counts.shape) != (e,)
                               or not counts.is_contiguous()):
        raise ValueError(f"{name}: counts must be a contiguous ({e},) int32 "
                         f"tensor, got {counts.dtype} {tuple(counts.shape)}")
    tensors = [t for t in (x, w, counts) if t is not None]
    if any(t.device.type != "cuda" for t in tensors):
        raise ValueError(f"{name}: the CUDA kernel takes CUDA tensors only, "
                         f"got devices {[str(t.device) for t in tensors]}")
    if len({t.device for t in tensors}) != 1:
        raise ValueError(f"{name}: tensors on more than one device")


def grouped_matmul_cuda(x, w, counts=None, *, out_dtype=None):
    """The CUDA kernel; CUDA tensors only.  x and w may be strided along
    their two leading axes (last axis contiguous); y is written
    contiguous.  ``counts`` (e,) int32 or None (every row live)."""
    out_dtype = out_dtype or x.dtype
    _check_inputs(x, w, counts, out_dtype)
    e, c, k = x.shape
    n = w.shape[2]
    y = torch.empty((e, c, n), dtype=out_dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _kernel()(
        _DTYPE_CODE[x.dtype], _DTYPE_CODE[out_dtype], x.data_ptr(),
        x.stride(0), x.stride(1), w.data_ptr(), w.stride(0), w.stride(1),
        counts.data_ptr() if counts is not None else None, y.data_ptr(),
        e, c, k, n, stream,
    )
    if err != 0:
        raise RuntimeError(f"grouped_matmul launch failed: CUDA error {err}")
    grouped_matmul.launches += 1
    return y


def grouped_matmul(x, w, counts=None, *, out_dtype=None):
    """``y[e] = x[e] @ w[e]``: CPU tensors -> the plain version, CUDA
    tensors -> the kernel."""
    if all(t is None or t.device.type == "cpu" for t in (x, w, counts)):
        return grouped_matmul_plain(x, w, counts, out_dtype=out_dtype)
    return grouped_matmul_cuda(x, w, counts, out_dtype=out_dtype)


grouped_matmul.launches = 0


def reset_counters() -> None:
    """Zero the launch and plain-call counters of this module."""
    grouped_matmul.launches = 0
    grouped_matmul_plain.calls = 0
