"""Policy-planned blocked matmul: the CUDA kernel's wrapper and its plain
PyTorch version.

Ports both Pallas kernels of ``repro/kernels/matmul/matmul.py`` with one
hand-written CUDA source (``csrc/matmul.cu``): ``_mm_kernel``, the
accumulating schedule (output ``RESIDENT_ACCUM``: an fp32 accumulator over
all of K, each output tile written once from on-chip), and the inline
split-K ``kern`` (output ``STREAM``: ``split_k`` ranges of K, each writing
an fp32 partial through to memory; the last unit to finish a tile, found by
a per-tile ticket, sums its partials in split order and casts, inside the
same kernel).  :func:`plan_launch` picks the kernel's body by shape, never
by catching a failure:

* ``wgmma`` (bf16, m > 64, rows and bases TMA-aligned): a persistent grid
  of one CTA an SM, a TMA producer and two ``wgmma`` consumer warpgroups
  over 128 x 256 CTA tiles;
* ``small_m`` (bf16, m <= 64, aligned): narrow column tiles and the K range
  of each tile split over a thread-block cluster (reduced on chip, in rank
  order), so that a decode step puts at least the SM count of CTAs to
  streaming the weights;
* ``cp_async`` / ``masked`` (bf16, shapes that fail the alignment): 128 x
  128 ``wmma`` tiles fed by ``cp.async`` or masked loads;
* ``cuda_cores`` (fp32): 64 x 64 tiles of fma, no TF32.

How the schedule's knobs read on the card:

* ``order`` (``"mnk"`` / ``"nmk"``) is the raster in which output tiles are
  taken, row-major or column-major; the split-K schedule runs row-major
  whatever the order, as the reference's split path ignores it;
* ``bm x bn`` is the L2 window: the group of CTA tiles that the raster
  finishes before it moves to the next window;
* ``bk`` is the split granule: ``ks`` and the split count follow the
  reference's rule on K rounded up to a multiple of ``bk``
  (:func:`split_ranges`), so every split sums the Pallas kernel's K range.

Every tile's K sum runs in a fixed order with no float atomics, so ``mnk``
and ``nmk`` are bitwise equal on the card, and so are repeated calls.  The
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
import dataclasses
import pathlib

import torch

from repro_torch.kernels.common import cdiv, load_library, refuse_grad
from repro_torch.kernels.matmul import ref

_SOURCE = pathlib.Path(__file__).parent / "csrc" / "matmul.cu"
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
BODIES = ("cuda_cores", "masked", "cp_async", "wgmma", "small_m")  # C codes
_MAX_SPLITS = 65535            # the non-persistent bodies' grid y
_SMALL_M = 64                  # rows the small_m body holds
_SMALL_K = 64                  # its K stage; a cluster rank's K slice is
_MIN_SLICE = 256               # a multiple of it, at least this deep
_MAX_CLUSTER = 8               # portable cluster size
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


@dataclasses.dataclass(frozen=True)
class Launch:
    """How the kernel runs one call: its body, the output tile of a work
    unit (rows, columns), the work units (output tiles x K splits), the
    CTAs launched, and the thread-block cluster that takes a unit:
    ``small_m`` splits the unit's K range over ``cluster`` CTAs, each
    summing ``kslice`` of it; ``wgmma`` gives each of its 2 CTAs 128 rows
    of the 256 x 256 unit, the two sharing b's tiles; the other bodies run
    one CTA a unit (cluster 1) over the split's whole K range."""

    body: str
    tile: tuple[int, int]
    units: int
    ctas: int
    cluster: int
    kslice: int


def plan_launch(m: int, k: int, n: int, dtype, *, lda: int, ldb: int,
                aligned: bool, ks: int, splits: int, sms: int,
                wgmma_ctas: int | None = None) -> Launch:
    """The kernel's launch for an (m, k) @ (k, n) product of ``dtype`` with
    row strides ``lda`` and ``ldb`` (``aligned``: both bases 16-byte
    aligned), ``splits`` K ranges of ``ks``, on a card of ``sms`` SMs that
    holds ``wgmma_ctas`` CTAs of the wgmma body at once (its 2-CTA clusters
    need two SMs of one GPC each; default: the SMs, rounded down to even).

    fp32 takes ``cuda_cores``.  bf16 takes the 16-byte-copy bodies when k,
    n, the row strides and ``ks`` are multiples of 8 and the bases aligned
    (else ``masked``): ``small_m`` for m <= 64, ``wgmma`` above it when a
    split's K range is whole 64-deep stages (TMA cannot stop inside one),
    else ``cp_async``.  ``wgmma`` is persistent: one CTA an SM, in pairs.
    ``small_m`` fills the card with the smallest K split it can: the widest
    column tile (128, 64, 32; 128 only for m <= 32, for the accumulators'
    registers) whose units times a cluster of at most 4 K slices reach one
    CTA an SM, else of at most 8, else 32 columns and the largest cluster;
    the cluster doubles only while the CTAs are fewer than the SMs and each
    slice stays at least 256 deep."""
    kk = min(ks, k)
    if dtype == torch.float32:
        units = cdiv(m, 64) * cdiv(n, 64) * splits
        return Launch("cuda_cores", (64, 64), units, units, 1, kk)
    vec = (aligned and k % 8 == 0 and n % 8 == 0 and lda % 8 == 0
           and ldb % 8 == 0 and ks % 8 == 0)
    if not vec or (m > _SMALL_M and splits > 1 and ks % 64):
        units = cdiv(m, 128) * cdiv(n, 128) * splits
        return Launch("cp_async" if vec else "masked", (128, 128), units,
                      units, 1, kk)
    if m > _SMALL_M:
        units = cdiv(m, 256) * cdiv(n, 256) * splits
        resident = wgmma_ctas or sms - sms % 2
        return Launch("wgmma", (256, 256), units, min(2 * units, resident),
                      2, kk)
    widths = (64, 32) if m > 32 else (128, 64, 32)
    for cap in (4, _MAX_CLUSTER):
        for bn in widths:
            units = cdiv(n, bn) * splits
            ck = 1
            while units * ck < sms and ck < cap and kk >= 2 * ck * _MIN_SLICE:
                ck *= 2
            if units * ck >= sms:
                break
        else:
            continue
        break
    kslice = cdiv(cdiv(kk, ck), _SMALL_K) * _SMALL_K
    return Launch("small_m", (_SMALL_M, bn), units, units * ck, ck, kslice)


def _bind(lib) -> None:
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.matmul.argtypes = [i32, i32, p, i64, p, i64, p, p, p, i32, i32, i32,
                           i32, i32, i32, i32, i32, i32, i32, i32, i32, i32,
                           p]
    lib.matmul.restype = i32
    lib.matmul_wgmma_ctas.argtypes = []
    lib.matmul_wgmma_ctas.restype = i32


def _load():
    """The kernel's library, built and loaded on first use."""
    return load_library(_SOURCE, _bind)


def _kernel():
    """The bound ``matmul`` C function."""
    return _load().matmul


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


_card: dict[int, tuple[int, int]] = {}


def _card_slots(device) -> tuple[int, int]:
    """(SMs, resident wgmma CTAs) of a CUDA device, asked once."""
    index = device.index if device.index is not None else (
        torch.cuda.current_device())
    if index not in _card:
        with torch.cuda.device(index):
            ctas = _load().matmul_wgmma_ctas()
        if ctas <= 0:
            raise RuntimeError(f"matmul: the wgmma body fits no cluster on "
                               f"device {index} (CUDA error {-ctas})")
        _card[index] = (torch.cuda.get_device_properties(
            index).multi_processor_count, ctas)
    return _card[index]


def _resolve(a, b, bm, bn, bk, order, split_k):
    """(ks, splits, col_major, launch, win_m, win_n) of one call."""
    m, k = a.shape
    n = b.shape[1]
    bm, bn, bk = min(bm, m), min(bn, n), min(bk, k)
    if split_k > 1:
        ks, splits = split_ranges(k, bk, split_k)
        if splits > _MAX_SPLITS:
            raise ValueError(f"matmul: {splits} splits, more than the "
                             f"kernel's {_MAX_SPLITS}")
        col_major = 0
    else:
        ks, splits, col_major = k, 1, int(order == "nmk")
    sms, wgmma_ctas = _card_slots(a.device)
    launch = plan_launch(
        m, k, n, a.dtype, lda=a.stride(0), ldb=b.stride(0),
        aligned=a.data_ptr() % 16 == 0 and b.data_ptr() % 16 == 0, ks=ks,
        splits=splits, sms=sms, wgmma_ctas=wgmma_ctas)
    win_m = max(1, bm // launch.tile[0])
    win_n = max(1, bn // launch.tile[1])
    return ks, splits, col_major, launch, win_m, win_n


def launch_of(a, b, *, bm: int = 256, bn: int = 256, bk: int = 256,
              order: str = "mnk", split_k: int = 1) -> Launch:
    """The :class:`Launch` that :func:`matmul_cuda` makes for these CUDA
    tensors and schedule (nothing is launched)."""
    return _resolve(a, b, bm, bn, bk, order, split_k)[3]


def matmul_cuda(a, b, *, bm: int = 256, bn: int = 256, bk: int = 256,
                order: str = "mnk", split_k: int = 1, out_dtype=None):
    """The CUDA kernel; CUDA tensors only.  a and b may be strided along
    their rows (last axis contiguous); the result is contiguous, in
    ``out_dtype`` from the kernel for both schedules."""
    refuse_grad("matmul", a, b)
    out_dtype = out_dtype or a.dtype
    _check_inputs(a, b, out_dtype, order, (bm, bn, bk, split_k))
    m, k = a.shape
    n = b.shape[1]
    ks, splits, col_major, launch, win_m, win_n = _resolve(
        a, b, bm, bn, bk, order, split_k)
    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    part = tickets = None
    if splits > 1:
        part = torch.empty((splits, m, n), dtype=torch.float32,
                           device=a.device)
        # One ticket per output tile (and cluster rank); the C entry zeroes
        # them on the stream.
        tickets = torch.empty(launch.units // splits * launch.cluster,
                              dtype=torch.int32, device=a.device)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    err = _kernel()(
        _DTYPE_CODE[a.dtype], _DTYPE_CODE[out_dtype], a.data_ptr(),
        a.stride(0), b.data_ptr(), b.stride(0), out.data_ptr(),
        part.data_ptr() if part is not None else None,
        tickets.data_ptr() if tickets is not None else None, m, k, n,
        splits, ks, win_m, win_n, col_major, BODIES.index(launch.body),
        launch.tile[1], launch.ctas, launch.cluster, launch.kslice, stream,
    )
    if err != 0:
        raise RuntimeError(f"matmul launch failed ({launch.body} body): "
                           f"CUDA error {err}")
    if split_k > 1:
        matmul.splitk_launches += 1
    else:
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
