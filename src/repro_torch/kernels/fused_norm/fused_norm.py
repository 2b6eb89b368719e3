"""Fused RMSNorm / LayerNorm (+ residual add, + bias): the CUDA kernel's
wrapper and its plain PyTorch version.

Ports ``repro/kernels/fused_norm/fused_norm.py`` (Pallas ``_norm_kernel``)
with one hand-written CUDA kernel (``csrc/fused_norm.cu``): a block per
row normalises it in fp32 in one pass over device memory.

Dispatch rule, as in every kernel package of the port: tensors on the CPU
take the plain version; CUDA tensors launch the kernel or raise.
``fused_norm.launches`` counts kernel launches; ``fused_norm_plain.calls``
counts plain-version calls.
"""
from __future__ import annotations

import ctypes
import pathlib

import torch

from repro_torch.kernels.common import load_library

_SOURCE = pathlib.Path(__file__).parent / "csrc" / "fused_norm.cu"
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MAX_D = 8192
_KINDS = ("rms", "layer")


def fused_norm_plain(x, weight, bias=None, residual=None, *, eps=1e-6,
                     kind="rms"):
    """Plain version of :func:`fused_norm`: the Pallas kernel's arithmetic
    in torch ops (fp32, ``rsqrt``), output in ``x.dtype``."""
    fused_norm_plain.calls += 1
    h = x.float()
    if residual is not None:
        h = h + residual.float()
    if kind == "layer":
        mu = h.mean(dim=-1, keepdim=True)
        var = (h - mu).square().mean(dim=-1, keepdim=True)
        y = (h - mu) * torch.rsqrt(var + eps)
    else:
        ms = h.square().mean(dim=-1, keepdim=True)
        y = h * torch.rsqrt(ms + eps)
    y = y * weight.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


fused_norm_plain.calls = 0


def _bind(lib) -> None:
    p, i32 = ctypes.c_void_p, ctypes.c_int
    lib.fused_norm.argtypes = [i32, i32, p, p, p, p, p, ctypes.c_int64, i32,
                               ctypes.c_float, i32, p]
    lib.fused_norm.restype = i32


_fused_norm = None


def _kernel():
    """The bound ``fused_norm`` C function, built and loaded on first use."""
    global _fused_norm
    if _fused_norm is None:
        _fused_norm = load_library(_SOURCE, _bind).fused_norm
    return _fused_norm


def _check_inputs(x, weight, bias, residual, kind):
    """Raise ValueError naming what the kernel does not take."""
    name = "fused_norm"
    if kind not in _KINDS:
        raise ValueError(f"{name}: kind must be one of {_KINDS}, got {kind!r}")
    if x.dtype not in _DTYPE_CODE or weight.dtype not in _DTYPE_CODE:
        raise ValueError(f"{name}: dtypes x {x.dtype}, weight {weight.dtype} "
                         f"not supported (takes {sorted(map(str, _DTYPE_CODE))})")
    d = x.shape[-1]
    if d > _MAX_D or x.numel() == 0:
        raise ValueError(f"{name}: row width {d} must be 1..{_MAX_D} and x "
                         "non-empty")
    if weight.shape != (d,) or (bias is not None and bias.shape != (d,)):
        raise ValueError(f"{name}: weight and bias must be ({d},)")
    if bias is not None and bias.dtype != weight.dtype:
        raise ValueError(f"{name}: bias dtype {bias.dtype} != weight dtype "
                         f"{weight.dtype}")
    if residual is not None and (residual.shape != x.shape
                                 or residual.dtype != x.dtype):
        raise ValueError(f"{name}: residual must match x in shape and dtype")
    tensors = [t for t in (x, weight, bias, residual) if t is not None]
    if any(not t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: x, residual, weight and bias must be "
                         "contiguous")
    if any(t.device.type != "cuda" for t in tensors):
        raise ValueError(f"{name}: the CUDA kernel takes CUDA tensors only, "
                         f"got devices {[str(t.device) for t in tensors]}")
    if len({t.device for t in tensors}) != 1:
        raise ValueError(f"{name}: tensors on more than one device")


def fused_norm_cuda(x, weight, bias=None, residual=None, *, eps=1e-6,
                    kind="rms"):
    """The CUDA kernel over contiguous (..., d) rows.  CUDA tensors only."""
    _check_inputs(x, weight, bias, residual, kind)
    out = torch.empty_like(x)
    rows = x.numel() // x.shape[-1]
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _kernel()(
        _DTYPE_CODE[x.dtype], _DTYPE_CODE[weight.dtype], x.data_ptr(),
        residual.data_ptr() if residual is not None else None,
        weight.data_ptr(), bias.data_ptr() if bias is not None else None,
        out.data_ptr(), rows, x.shape[-1], float(eps),
        int(kind == "layer"), stream,
    )
    if err != 0:
        raise RuntimeError(f"fused_norm launch failed: CUDA error {err}")
    fused_norm.launches += 1
    return out


def fused_norm(x, weight, bias=None, residual=None, *, eps=1e-6, kind="rms"):
    """Normalise the last axis of ``x`` (+ ``residual``) in fp32: RMS or
    LayerNorm, times ``weight`` (d,), plus ``bias`` (d,) if given; output
    in ``x.dtype``.  CPU tensors -> plain version, CUDA tensors -> kernel."""
    if all(t is None or t.device.type == "cpu"
           for t in (x, weight, bias, residual)):
        return fused_norm_plain(x, weight, bias, residual, eps=eps, kind=kind)
    return fused_norm_cuda(x, weight, bias, residual, eps=eps, kind=kind)


fused_norm.launches = 0


def reset_counters() -> None:
    """Zero the launch and plain-call counters of this module."""
    fused_norm.launches = 0
    fused_norm_plain.calls = 0
