"""MoE grouped expert GEMM: the CUDA kernel's wrapper and its plain PyTorch
version.

Ports ``repro/kernels/moe_gmm/moe_gmm.py`` (Pallas ``grouped_matmul``,
``_gmm_kernel``) with one hand-written CUDA source (``csrc/moe_gmm.cu``)
that computes what the Pallas kernel computes: ``y[e] = x[e] @ w[e]`` over
per-expert capacity buffers, an fp32 accumulator, rows at or past
``counts[e]`` written as exact zeros and row tiles wholly past ``counts[e]``
skipped (``counts`` is read on the card, never by the host).
:func:`plan_launch` picks the kernel's body by shape alone, never by the
counts, the content or a caught failure:

* ``wgmma`` (bf16, more than 64 rows an expert, TMA-aligned): a persistent
  grid of 2-CTA clusters, a TMA producer and two ``wgmma`` consumer
  warpgroups over (expert, 256-row, 256-column) work units;
* ``decode`` (bf16, at most 64 rows, aligned): a CTA an (expert,
  128-column tile), streaming w through a ``cp.async`` ring into
  ``mma.sync``;
* ``wmma`` (bf16 shapes that fail the alignment): 128 x 128 ``wmma`` tiles
  fed by masked loads;
* ``cuda_cores`` (fp32): 64 x 64 tiles of fma, no TF32.

Every sum runs over K in a fixed order (no atomics, no split-K), so a call
is bitwise reproducible, and a row's result does not depend on what the
other rows hold.

* :func:`grouped_matmul_plain` is the oracle's math (``ref.py``): the CPU
  path and the kernel's yardstick on the card.
* :func:`grouped_matmul_cuda` launches the kernel; CUDA tensors only.

Dispatch rule, as in every kernel package of the port: tensors on the CPU
take the plain version; CUDA tensors launch the kernel or raise.
``grouped_matmul.launches`` counts kernel launches (``body_launches`` the
same launches by body); ``grouped_matmul_plain.calls`` counts plain-version
calls.
"""
from __future__ import annotations

import ctypes
import dataclasses
import pathlib

import torch

from repro_torch.kernels.common import cdiv, load_library, refuse_grad
from repro_torch.kernels.moe_gmm import ref

_SOURCE = pathlib.Path(__file__).parent / "csrc" / "moe_gmm.cu"
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
BODIES = ("cuda_cores", "wmma", "wgmma", "decode")   # the C entry's codes
_DECODE_ROWS = 64            # the decode body holds 4 fragments of 16 rows
_MAX_EXPERTS = 65535         # the grid bodies' grid z
_INT_MAX = 2 ** 31 - 1
# Rows an expert that the grid bodies reach (65535 row tiles, their grid's
# y); the persistent wgmma body and the decode body have no such limit.
_MAX_ROWS = {"cuda_cores": 64 * 65535, "wmma": 128 * 65535}


def grouped_matmul_plain(x, w, counts=None, *, out_dtype=None):
    """x (e, c, k), w (e, k, n), counts (e,) or None -> (e, c, n) in
    ``out_dtype`` (default x's): fp32 einsum, rows past counts zeroed."""
    grouped_matmul_plain.calls += 1
    return ref.grouped_matmul(x, w, counts, out_dtype=out_dtype)


grouped_matmul_plain.calls = 0


def plan_launch(e: int, c: int, k: int, n: int, dtype, *,
                strides: tuple[int, int, int, int], aligned: bool) -> str:
    """The body that runs an (e, c, k) @ (e, k, n) grouped product of
    ``dtype``, by shape alone: ``strides`` are x's expert and row strides
    then w's (elements), ``aligned`` says both bases are 16-byte aligned.

    fp32 takes ``cuda_cores``.  bf16 takes the TMA / ``cp.async`` bodies
    when k and n are multiples of 8 and every stride a positive multiple of
    8 (16-byte rows; a stride of 0 is a broadcast that no tensor map
    describes) with aligned bases: ``decode`` for at most 64 rows an
    expert, ``wgmma`` above; other bf16 shapes take ``wmma``."""
    if dtype == torch.float32:
        return "cuda_cores"
    tma = (aligned and k % 8 == 0 and n % 8 == 0
           and all(s > 0 and s % 8 == 0 for s in strides))
    if not tma:
        return "wmma"
    return "decode" if c <= _DECODE_ROWS else "wgmma"


def launch_of(x, w, counts=None) -> str:
    """The body :func:`grouped_matmul_cuda` runs for these tensors (nothing
    is launched; ``counts`` is taken as the call takes it and never read:
    the body does not depend on it)."""
    return plan_launch(
        *x.shape, w.shape[2], x.dtype,
        strides=(x.stride(0), x.stride(1), w.stride(0), w.stride(1)),
        aligned=x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0)


@dataclasses.dataclass(frozen=True)
class Grid:
    """How a body covers one call: its work units (output tiles), the CTAs
    launched and the thread-block cluster of a unit.  ``wgmma`` is
    persistent (at most the CTAs the card holds at once, in pairs, each
    pair taking 256 x 256 units); ``decode`` runs a CTA an (expert,
    128-column tile); ``wmma`` a CTA a 128 x 128 tile, ``cuda_cores`` a CTA
    a 64 x 64 tile."""

    units: int
    ctas: int
    cluster: int


def grid_of(body: str, e: int, c: int, n: int, *,
            resident: int | None = None) -> Grid:
    """The :class:`Grid` of ``body`` for an (e, c, k) @ (e, k, n) call, on a
    card that holds ``resident`` CTAs of the wgmma body at once (None: a
    CTA pair a unit)."""
    if body == "wgmma":
        units = e * cdiv(c, 256) * cdiv(n, 256)
        return Grid(units, min(2 * units, resident or 2 * units), 2)
    if body == "decode":
        return Grid(e * cdiv(n, 128), e * cdiv(n, 128), 1)
    tile = 128 if body == "wmma" else 64
    units = e * cdiv(c, tile) * cdiv(n, tile)
    return Grid(units, units, 1)


def _bind(lib) -> None:
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.moe_gmm.argtypes = [i32, i32, p, i64, i64, p, i64, i64, p, p,
                            i32, i32, i32, i32, i32, i32, p]
    lib.moe_gmm.restype = i32
    lib.moe_gmm_wgmma_ctas.argtypes = []
    lib.moe_gmm_wgmma_ctas.restype = i32


def _load():
    """The kernel's library, built and loaded on first use."""
    return load_library(_SOURCE, _bind)


def _kernel():
    """The bound ``moe_gmm`` C function."""
    return _load().moe_gmm


_resident: dict[int, int] = {}


def resident_ctas(device) -> int:
    """CTAs of the wgmma body that a CUDA device holds at once, asked once."""
    index = device.index if device.index is not None else (
        torch.cuda.current_device())
    if index not in _resident:
        with torch.cuda.device(index):
            ctas = _load().moe_gmm_wgmma_ctas()
        if ctas <= 0:
            raise RuntimeError(f"grouped_matmul: the wgmma body fits no "
                               f"cluster on device {index} (CUDA error "
                               f"{-ctas})")
        _resident[index] = ctas
    return _resident[index]


def _check_inputs(x, w, counts, out_dtype) -> str:
    """Raise ValueError naming what the kernel does not take; else return
    the body that runs the call."""
    name = "grouped_matmul"
    if x.dim() != 3 or w.dim() != 3:
        raise ValueError(f"{name}: x (e, c, k) and w (e, k, n) expected, got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    e, c, k = x.shape
    n = w.shape[2]
    if w.shape[0] != e or w.shape[1] != k:
        raise ValueError(f"{name}: shapes disagree: x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}")
    if min(e, c, k, n) < 1 or e > _MAX_EXPERTS or max(c, k, n) > _INT_MAX:
        raise ValueError(f"{name}: dimensions out of the kernel's range "
                         f"(each at least 1, at most {_MAX_EXPERTS} experts "
                         f"and {_INT_MAX} rows, k or n), got x "
                         f"{tuple(x.shape)}, w {tuple(w.shape)}")
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
    body = launch_of(x, w, counts)
    if (c > _MAX_ROWS.get(body, _INT_MAX)
            or grid_of(body, e, c, n).units > _INT_MAX):
        raise ValueError(f"{name}: dimensions out of the kernel's range (the "
                         f"{body} body takes at most "
                         f"{_MAX_ROWS.get(body, _INT_MAX)} rows an expert "
                         f"and {_INT_MAX} tiles), got x {tuple(x.shape)}, "
                         f"w {tuple(w.shape)}")
    return body


def grouped_matmul_cuda(x, w, counts=None, *, out_dtype=None):
    """The CUDA kernel; CUDA tensors only.  x and w may be strided along
    their two leading axes (last axis contiguous); y is written
    contiguous.  ``counts`` (e,) int32 or None (every row live)."""
    refuse_grad("grouped_matmul", x, w)
    out_dtype = out_dtype or x.dtype
    body = _check_inputs(x, w, counts, out_dtype)
    e, c, k = x.shape
    n = w.shape[2]
    ctas = (grid_of(body, e, c, n, resident=resident_ctas(x.device)).ctas
            if body == "wgmma" else 0)
    y = torch.empty((e, c, n), dtype=out_dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _kernel()(
        _DTYPE_CODE[x.dtype], _DTYPE_CODE[out_dtype], x.data_ptr(),
        x.stride(0), x.stride(1), w.data_ptr(), w.stride(0), w.stride(1),
        counts.data_ptr() if counts is not None else None, y.data_ptr(),
        e, c, k, n, BODIES.index(body), ctas, stream,
    )
    if err != 0:
        raise RuntimeError(f"grouped_matmul launch failed ({body} body): "
                           f"CUDA error {err}")
    grouped_matmul.launches += 1
    grouped_matmul.body_launches[body] += 1
    return y


def grouped_matmul(x, w, counts=None, *, out_dtype=None):
    """``y[e] = x[e] @ w[e]``: CPU tensors -> the plain version, CUDA
    tensors -> the kernel."""
    if all(t is None or t.device.type == "cpu" for t in (x, w, counts)):
        return grouped_matmul_plain(x, w, counts, out_dtype=out_dtype)
    return grouped_matmul_cuda(x, w, counts, out_dtype=out_dtype)


grouped_matmul.launches = 0
grouped_matmul.body_launches = dict.fromkeys(BODIES, 0)


def reset_counters() -> None:
    """Zero the launch and plain-call counters of this module."""
    grouped_matmul.launches = 0
    grouped_matmul.body_launches = dict.fromkeys(BODIES, 0)
    grouped_matmul_plain.calls = 0
