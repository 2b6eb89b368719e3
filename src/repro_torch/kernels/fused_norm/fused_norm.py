"""Fused RMSNorm / LayerNorm (+ residual add, + bias): the CUDA kernel's
wrapper and its plain PyTorch version.

Ports ``repro/kernels/fused_norm/fused_norm.py`` (Pallas ``_norm_kernel``)
with one hand-written CUDA source (``csrc/fused_norm.cu``) that normalises
each row in fp32 in one pass over device memory.  :func:`plan_launch` picks
its body by width and alignment, never by catching a failure:

* ``vector`` (d a multiple of 8, every base 16-byte aligned): 16-byte
  loads and stores (8 bf16 or 4 fp32), a warp or a few a row (``tpr``
  threads), the row in registers at its own width, several rows a block
  with the weight (and bias) in registers once for all of them and the
  next rows' loads in flight while the current ones reduce;
* ``scalar`` (the other rows): a block of 256 threads a row, element
  loads.

Dispatch rule, as in every kernel package of the port: tensors on the CPU
take the plain version; CUDA tensors launch the kernel or raise.
``fused_norm.launches`` counts kernel launches; ``fused_norm_plain.calls``
counts plain-version calls.
"""
from __future__ import annotations

import ctypes
import dataclasses
import pathlib

import torch

from repro_torch.kernels.common import cdiv, load_library, refuse_grad

_SOURCE = pathlib.Path(__file__).parent / "csrc" / "fused_norm.cu"
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_ESIZE = {torch.float32: 4, torch.bfloat16: 2}
_MAX_D = 8192
_KINDS = ("rms", "layer")
BODIES = ("scalar", "vector")    # C codes
_BLOCK = 256                     # threads a block (both bodies)
_MAX_VEC = 5                     # 16-byte vectors a thread holds
_BLOCKS_PER_SM = 4               # the vector body's grid: at least this x
_MAX_GROUPS = 8                  # SMs, and enough that a block strides over
                                 # at most this many groups of rows


@dataclasses.dataclass(frozen=True)
class Launch:
    """How the kernel runs one call: its body, the threads a row (``tpr``)
    and the 16-byte vectors each holds (``vec``; 0 for ``scalar``), the
    blocks launched and the most rows a block takes (``rows_per_cta``:
    256 / tpr at once, striding over the rows)."""

    body: str
    tpr: int
    vec: int
    ctas: int
    rows_per_cta: int


def plan_launch(rows: int, d: int, dtype, *, aligned: bool,
                sms: int = 132) -> Launch:
    """The kernel's launch for ``rows`` rows of width ``d`` in ``dtype``
    (``aligned``: every base 16-byte aligned).

    d a multiple of 8 and aligned takes ``vector`` where 256 threads
    cover the row with at most 5 vectors of 16 bytes each (8 bf16 or 4
    fp32: d up to 10240 in bf16, 5120 in fp32): the fewest threads a row
    (32, 64, 128, 256) that leave each at most 5 vectors, then twice as
    many while the blocks are fewer than
    the SMs and each thread keeps at least one vector.  A block takes 256 /
    tpr rows at once and strides over the rows: the grid is 4 blocks an SM,
    or more so that no block takes more than 8 such groups (fewer blocks
    reload the weight less; more keep a block's chain of rows short).
    Everything else takes ``scalar``: a block a row.  So do fp32 rows that
    need all 256 threads of a block (d over 2560) when they fill the card
    (at least 4 rows an SM): there both bodies run a row a block, and the
    scalar one was the faster on an H100 at 16 x 1024 x 4096, the vector
    one at 16 rows of 4096 (chip_smoke.py ``kernels_norm``, PERF.md §6)."""
    units = d * _ESIZE[dtype] // 16
    if not aligned or d % 8 or cdiv(units, _BLOCK) > _MAX_VEC:
        return Launch("scalar", _BLOCK, 0, rows, 1)
    tpr = 32
    while cdiv(units, tpr) > _MAX_VEC:
        tpr *= 2
    if (dtype == torch.float32 and tpr == _BLOCK
            and rows >= _BLOCKS_PER_SM * sms):
        return Launch("scalar", _BLOCK, 0, rows, 1)
    while (tpr < _BLOCK and cdiv(rows, _BLOCK // tpr) < sms
           and units >= 2 * tpr):
        tpr *= 2
    groups = cdiv(rows, _BLOCK // tpr)
    ctas = min(groups, max(_BLOCKS_PER_SM * sms, cdiv(groups, _MAX_GROUPS)))
    return Launch("vector", tpr, cdiv(units, tpr), ctas,
                  min(rows, cdiv(groups, ctas) * (_BLOCK // tpr)))


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
    lib.fused_norm.argtypes = [i32, i32, i32, i32, i32, p, p, p, p, p,
                               ctypes.c_int64, i32, ctypes.c_float, i32, p]
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


def launch_of(x, weight, bias=None, residual=None, *, kind="rms") -> Launch:
    """The :class:`Launch` that :func:`fused_norm_cuda` makes for these CUDA
    tensors (nothing is launched)."""
    _check_inputs(x, weight, bias, residual, kind)
    aligned = all(t.data_ptr() % 16 == 0
                  for t in (x, weight, bias, residual) if t is not None)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    return plan_launch(x.numel() // x.shape[-1], x.shape[-1], x.dtype,
                       aligned=aligned, sms=sms)


def fused_norm_cuda(x, weight, bias=None, residual=None, *, eps=1e-6,
                    kind="rms", launch: Launch | None = None):
    """The CUDA kernel over contiguous (..., d) rows.  CUDA tensors only.
    ``launch`` defaults to :func:`launch_of`'s; another plan (``scalar`` on
    aligned rows, to time it) runs if its body takes these rows, else the
    C entry refuses it and this raises."""
    refuse_grad("fused_norm", x, weight, bias, residual)
    if launch is None:
        launch = launch_of(x, weight, bias, residual, kind=kind)
    else:
        _check_inputs(x, weight, bias, residual, kind)
    out = torch.empty_like(x)
    rows = x.numel() // x.shape[-1]
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _kernel()(
        BODIES.index(launch.body), launch.tpr, launch.ctas,
        _DTYPE_CODE[x.dtype], _DTYPE_CODE[weight.dtype], x.data_ptr(),
        residual.data_ptr() if residual is not None else None,
        weight.data_ptr(), bias.data_ptr() if bias is not None else None,
        out.data_ptr(), rows, x.shape[-1], float(eps),
        int(kind == "layer"), stream,
    )
    if err != 0:
        raise RuntimeError(f"fused_norm launch failed ({launch.body} body): "
                           f"CUDA error {err}")
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
