"""Mamba-2 SSD chunked scan: the CUDA kernel's wrapper, its plain PyTorch
version, and the single-token decode update.

Ports ``repro/kernels/ssd/ssd.py`` (Pallas ``_ssd_kernel``) with one
hand-written CUDA source (``csrc/ssd.cu``): a block walks the chunks of its
batch row in a loop with the (ds, dh) fp32 state on chip, read from
``init_state`` once and written once (the reference's ``RESIDENT_ACCUM``
state; x, B, C, dt and y stream through once).  Beyond the Pallas kernel it
takes ``init_state`` (b, h, ds, dh), as ``repro.models.mamba2.ssd_chunked``
does: every serve prefill continues each slot's state, and a parked slot
(dt = 0 on every row) comes out with its state bitwise unchanged.
:func:`plan_launch` picks the kernel's body by dtype, shape and alignment,
never by catching a failure:

* ``mma`` (bf16, head dim a multiple of 16, state dim a multiple of 8 up to
  128, 16-byte aligned rows): the products on the tensor cores
  (``mma.sync``); a block takes ``hb`` heads of one group and computes
  their shared C B^T once a chunk; each warp keeps 16 columns of a head's
  state as accumulator fragments; an fp32 operand v enters a bf16 product
  as hi = bf16(v) plus lo = bf16(v - hi), ~16 bits of its mantissa;
* ``cuda_cores`` (fp32, and the other bf16 shapes): fp32 fma, a block per
  (batch, head), the state in shared memory.

* :func:`ssd_plain` is the port of ``ssd_chunked`` (the reference's XLA
  path, the same chunked math as the kernel) with its chunk rule: the CPU
  path, the ``"xla"`` route, and the kernel's yardstick on the card.
* :func:`ssd_cuda` launches the kernel; CUDA tensors only.  Its chunk tile
  is fixed (64 rows): the chunked algorithm is exact for any tile, so it
  differs from the plain version only in rounding.
* :func:`ssd_decode_step` is the reference's O(1) single-token update,
  plain torch ops on both devices (it is plain ``jnp`` in the reference).

Dispatch rule, as in every kernel package of the port: tensors on the CPU
take the plain version; CUDA tensors launch the kernel or raise.
``ssd.launches`` counts kernel launches; ``ssd_plain.calls`` counts
plain-version calls.
"""
from __future__ import annotations

import ctypes
import dataclasses
import pathlib

import torch
import torch.nn.functional as F

from repro_torch.kernels.common import load_library, refuse_grad

_SOURCE = pathlib.Path(__file__).parent / "csrc" / "ssd.cu"
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
BODIES = ("cuda_cores", "mma")   # C codes
KERNEL_CHUNK = 64            # the kernel's chunk tile (kQ in csrc/ssd.cu)
_MAX_DH = 128
_MAX_SMEM = 232448           # bytes of shared memory a block may use
_MMA_MAX_WARPS = 16          # warps a block of the mma body (and an SM)
_SM_SMEM = 233472            # shared memory of an SM (1 KB more a block)
_CB_STRIDE = KERNEL_CHUNK + 8


def _mma_ds(ds: int) -> int:
    """The mma body's state width: ds rounded up to 32, 64 or 128."""
    return 32 if ds <= 32 else 64 if ds <= 64 else 128


def smem_bytes(dh: int, ds: int, *, body: str = "cuda_cores",
               hb: int = 1) -> int:
    """Shared memory the kernel asks for (``fma_smem_floats`` and
    ``mma_smem_bytes`` in csrc/ssd.cu).  cuda_cores: fp32 x, B, C, M and
    the state.  mma: two ring stages of bf16 x (``hb`` heads), B and C
    (rows padded by 16 bytes) and fp32 dt, C B^T in fp32, and three fp32
    vectors a head."""
    q = KERNEL_CHUNK
    if body == "mma":
        DS = _mma_ds(ds)
        stage = hb * q * (dh + 8) * 2 + 2 * q * (DS + 8) * 2 + hb * q * 4
        return 2 * stage + q * _CB_STRIDE * 4 + 3 * hb * q * 4
    DH = 64 if dh <= 64 else 128
    return 4 * (q * (DH + 4) + 2 * q * (ds + 4) + q * (q + 4)
                + ds * (DH + 4) + 4 * q)


@dataclasses.dataclass(frozen=True)
class Launch:
    """How the kernel runs one call: its body, the heads a block takes
    (``hb``, all of one group; 1 for cuda_cores), the blocks launched, the
    threads a block and its dynamic shared memory."""

    body: str
    hb: int
    ctas: int
    threads: int
    smem: int


def plan_launch(b: int, h: int, dh: int, g: int, ds: int, dtype, *,
                aligned: bool, sms: int = 132) -> Launch:
    """The kernel's launch for a scan of ``b`` rows of ``h`` heads (head dim
    ``dh``) over ``g`` groups of state dim ``ds`` in ``dtype``; ``aligned``:
    the bases of x, B and C 16-byte aligned and their strides multiples of
    8 elements.

    bf16 takes ``mma`` when dh is a multiple of 16 (up to 128), ds a
    multiple of 8 up to 128 and the rows aligned; it runs dh / 16 warps a
    head and ``hb`` heads a block, hb a divisor of the heads a group with
    at most 16 warps and the shared memory within the limit.  Its launch
    bounds cap a thread at 128 registers, so an SM holds 16 of its warps
    at most, fewer where shared memory runs out first; hb is the one that
    keeps the most warps busy on the card (blocks resident at once, up to
    the grid's b * h / hb, times warps a block), and of those the one with
    the most blocks (a finer grid balances the last wave).  Everything
    else takes ``cuda_cores``: a block of 256 threads per (batch, head)."""
    wph = dh // 16
    if (dtype == torch.bfloat16 and aligned and dh % 16 == 0
            and dh <= _MAX_DH and ds % 8 == 0 and ds <= 128):
        hpg = h // g
        best = None
        for hb in range(1, hpg + 1):
            smem = smem_bytes(dh, ds, body="mma", hb=hb)
            if hpg % hb or hb * wph > _MMA_MAX_WARPS or smem > _MAX_SMEM:
                continue
            ctas = b * h // hb
            resident = min(_SM_SMEM // (smem + 1024),
                           _MMA_MAX_WARPS // (hb * wph))
            score = (min(ctas, sms * resident) * hb * wph, ctas)
            if best is None or score > best[0]:
                best = (score, Launch("mma", hb, ctas, 32 * hb * wph, smem))
        if best is not None:
            return best[1]
    return Launch("cuda_cores", 1, b * h, 256, smem_bytes(dh, ds))


# ---------------------------------------------------------------------------
# Plain PyTorch version (the CPU path, the "xla" route, the yardstick)
# ---------------------------------------------------------------------------

def ssd_plain(x, dt, A, B, C, D=None, *, chunk: int = 128, init_state=None):
    """x (b, l, h, dh), dt (b, l, h), A (h,), B/C (b, l, g, ds), D (h,) or
    None, init_state (b, h, ds, dh) or None -> (y in x's dtype, final state
    fp32).  The port of ``repro.models.mamba2.ssd_chunked``: a loop over
    chunks of ``min(chunk, l)`` rows, masked decay matrix built before exp."""
    ssd_plain.calls += 1
    b, l, h, dh = x.shape
    g, ds = B.shape[2], B.shape[3]
    hpg = h // g
    q = min(chunk, l)
    pad = (-l) % q
    xdt = x.float() * dt.float()[..., None]
    alog = dt.float() * A.float()[None, None, :]
    Bf, Cf = B.float(), C.float()
    if pad:          # dt = 0 on padding: decay exp(0) = 1, no contribution
        xdt = F.pad(xdt, (0, 0, 0, 0, 0, pad))
        alog = F.pad(alog, (0, 0, 0, pad))
        Bf = F.pad(Bf, (0, 0, 0, 0, 0, pad))
        Cf = F.pad(Cf, (0, 0, 0, 0, 0, pad))
    nc = (l + pad) // q
    xdt_c = xdt.reshape(b, nc, q, h, dh)
    alog_c = alog.reshape(b, nc, q, h)
    b_c = Bf.reshape(b, nc, q, g, ds)
    c_c = Cf.reshape(b, nc, q, g, ds)
    idx = torch.arange(q, device=x.device)
    tril = idx[None, :] <= idx[:, None]                  # (t, s): s <= t
    S = (torch.zeros((b, h, ds, dh), dtype=torch.float32, device=x.device)
         if init_state is None else init_state.float())
    ys = []
    for c in range(nc):
        xd, al, bb, cc = xdt_c[:, c], alog_c[:, c], b_c[:, c], c_c[:, c]
        cum = torch.cumsum(al, dim=1)                    # (b, q, h)
        cumT = cum.transpose(1, 2)                       # (b, h, q)
        diff = cumT[:, :, :, None] - cumT[:, :, None, :]
        # Mask BEFORE exp: the s > t lanes have positive diffs that overflow.
        lmat = torch.exp(torch.where(tril, diff, float("-inf")))
        cb = torch.einsum("btgd,bsgd->bgts", cc, bb)
        cb = cb.repeat_interleave(hpg, dim=1)            # (b, h, t, s)
        y_intra = torch.einsum("bhts,bshd->bthd", cb * lmat, xd)
        cch = cc.repeat_interleave(hpg, dim=2)           # (b, q, h, ds)
        y_inter = torch.exp(cumT).transpose(1, 2)[..., None] * torch.einsum(
            "bthn,bhnd->bthd", cch, S)
        total = cumT[:, :, -1]                           # (b, h)
        bbh = bb.repeat_interleave(hpg, dim=2)           # (b, q, h, ds)
        b_scaled = bbh * torch.exp(total[:, None, :] - cum)[..., None]
        S = S * torch.exp(total)[..., None, None] + torch.einsum(
            "bshn,bshd->bhnd", b_scaled, xd)
        ys.append(y_intra + y_inter)
    y = torch.stack(ys, dim=1).reshape(b, nc * q, h, dh)[:, :l]
    if D is not None:
        y = y + D[None, None, :, None] * x.float()
    return y.to(x.dtype), S


ssd_plain.calls = 0


# ---------------------------------------------------------------------------
# CUDA kernel launch
# ---------------------------------------------------------------------------

def _bind(lib) -> None:
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.ssd_scan.argtypes = [
        i32, i32, i32, p, i64, i64, i64, p, i64, i64, i64, p, p, i64, i64,
        i64, p, i64, i64, i64, p, p, p, p, i32, i32, i32, i32, i32, i32, p,
    ]
    lib.ssd_scan.restype = i32


_ssd = None


def _kernel():
    """The bound ``ssd_scan`` C function, built and loaded on first use."""
    global _ssd
    if _ssd is None:
        _ssd = load_library(_SOURCE, _bind).ssd_scan
    return _ssd


def _check_inputs(x, dt, A, B, C, D, init_state):
    """Raise ValueError naming what the kernel does not take."""
    name = "ssd"
    if x.dim() != 4 or dt.dim() != 3 or B.dim() != 4 or C.dim() != 4:
        raise ValueError(f"{name}: x (b, l, h, dh), dt (b, l, h) and B/C "
                         f"(b, l, g, ds) expected, got {tuple(x.shape)}, "
                         f"{tuple(dt.shape)}, {tuple(B.shape)}, "
                         f"{tuple(C.shape)}")
    b, l, h, dh = x.shape
    g, ds = B.shape[2], B.shape[3]
    if x.dtype not in _DTYPE_CODE or B.dtype != x.dtype or C.dtype != x.dtype:
        raise ValueError(f"{name}: x, B and C must share a dtype of "
                         f"{sorted(map(str, _DTYPE_CODE))}, got {x.dtype}, "
                         f"{B.dtype}, {C.dtype}")
    if tuple(dt.shape) != (b, l, h) or tuple(C.shape) != tuple(B.shape) or \
            B.shape[:2] != x.shape[:2]:
        raise ValueError(f"{name}: shapes disagree: x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, B {tuple(B.shape)}, C "
                         f"{tuple(C.shape)}")
    if l < 1 or g < 1 or h % g:
        raise ValueError(f"{name}: need l >= 1 and heads {h} a multiple of "
                         f"groups {g}")
    if dh > _MAX_DH or ds % 4 or ds < 4:
        raise ValueError(f"{name}: head dim {dh} must be at most {_MAX_DH} "
                         f"and state dim {ds} a positive multiple of 4")
    launch = plan_launch(b, h, dh, g, ds, x.dtype, aligned=_aligned(x, B, C))
    if launch.smem > _MAX_SMEM:
        raise ValueError(f"{name}: head dim {dh} and state dim {ds} need "
                         f"{launch.smem} bytes of shared memory, more than "
                         f"{_MAX_SMEM}")
    if x.stride(-1) != 1 or B.stride(-1) != 1 or C.stride(-1) != 1:
        raise ValueError(f"{name}: the last axis of x, B and C must be "
                         "contiguous (stride 1)")
    for label, t, shape in (("dt", dt, None), ("A", A, (h,)),
                            ("D", D, (h,)), ("init_state", init_state,
                                             (b, h, ds, dh))):
        if t is None:
            continue
        if t.dtype != torch.float32:
            raise ValueError(f"{name}: {label} must be float32, got {t.dtype}")
        if shape is not None and (tuple(t.shape) != shape
                                  or not t.is_contiguous()):
            raise ValueError(f"{name}: {label} must be a contiguous {shape} "
                             f"tensor, got {tuple(t.shape)}")
    tensors = [t for t in (x, dt, A, B, C, D, init_state) if t is not None]
    if any(t.device.type != "cuda" for t in tensors):
        raise ValueError(f"{name}: the CUDA kernel takes CUDA tensors only, "
                         f"got devices {[str(t.device) for t in tensors]}")
    if len({t.device for t in tensors}) != 1:
        raise ValueError(f"{name}: tensors on more than one device")


def _aligned(x, B, C) -> bool:
    """The mma body's alignment: 16-byte bases and strides of x, B and C
    that are multiples of 8 elements (whole 16-byte row pieces)."""
    return all(t.data_ptr() % 16 == 0
               and all(st % 8 == 0 for st in t.stride()[:-1])
               for t in (x, B, C))


def launch_of(x, dt, A, B, C, D=None, *, init_state=None) -> Launch:
    """The :class:`Launch` that :func:`ssd_cuda` makes for these CUDA
    tensors (nothing is launched)."""
    _check_inputs(x, dt, A, B, C, D, init_state)
    b, _, h, dh = x.shape
    g, ds = B.shape[2], B.shape[3]
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    return plan_launch(b, h, dh, g, ds, x.dtype, aligned=_aligned(x, B, C),
                       sms=sms)


def ssd_cuda(x, dt, A, B, C, D=None, *, init_state=None,
             launch: Launch | None = None):
    """The CUDA kernel (chunk tile ``KERNEL_CHUNK``); CUDA tensors only.
    x, B and C may be strided views with a contiguous last axis (the model
    passes slices of its conv output); y is written contiguous.
    ``launch`` defaults to :func:`launch_of`'s; another plan (the
    ``cuda_cores`` body on bf16, to time it) runs if its body takes these
    inputs, else the C entry refuses it and this raises."""
    refuse_grad("ssd", x, dt, A, B, C, D, init_state)
    if launch is None:
        launch = launch_of(x, dt, A, B, C, D, init_state=init_state)
    else:
        _check_inputs(x, dt, A, B, C, D, init_state)
    b, l, h, dh = x.shape
    g, ds = B.shape[2], B.shape[3]
    y = torch.empty((b, l, h, dh), dtype=x.dtype, device=x.device)
    s_out = torch.empty((b, h, ds, dh), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _kernel()(
        BODIES.index(launch.body), launch.hb, _DTYPE_CODE[x.dtype],
        x.data_ptr(), x.stride(0), x.stride(1), x.stride(2), dt.data_ptr(),
        dt.stride(0), dt.stride(1), dt.stride(2), A.data_ptr(),
        B.data_ptr(), B.stride(0), B.stride(1), B.stride(2),
        C.data_ptr(), C.stride(0), C.stride(1), C.stride(2),
        D.data_ptr() if D is not None else None,
        init_state.data_ptr() if init_state is not None else None,
        y.data_ptr(), s_out.data_ptr(), b, l, h, g, dh, ds, stream,
    )
    if err != 0:
        raise RuntimeError(f"ssd launch failed ({launch.body} body): CUDA "
                           f"error {err}")
    ssd.launches += 1
    return y, s_out


def ssd(x, dt, A, B, C, D=None, *, chunk: int = 128, init_state=None):
    """The SSD chunked scan with an initial state: CPU tensors -> the plain
    version (chunks of ``chunk`` rows), CUDA tensors -> the kernel (its own
    64-row tile; ``chunk`` is not read)."""
    if all(t is None or t.device.type == "cpu"
           for t in (x, dt, A, B, C, D, init_state)):
        return ssd_plain(x, dt, A, B, C, D, chunk=chunk,
                         init_state=init_state)
    return ssd_cuda(x, dt, A, B, C, D, init_state=init_state)


ssd.launches = 0


def reset_counters() -> None:
    """Zero the launch and plain-call counters of this module."""
    ssd.launches = 0
    ssd_plain.calls = 0


# ---------------------------------------------------------------------------
# Single-token decode update (plain torch on both devices)
# ---------------------------------------------------------------------------

def ssd_decode_step(x, dt, A, B, C, D, state):
    """O(1)-state single-token update: x (b, h, dh), dt (b, h), A (h,),
    B/C (b, g, ds), D (h,) or None, state (b, h, ds, dh) fp32 -> (y (b, h,
    dh) in x's dtype, new state).  With dt = 0 the new state is bitwise the
    old one (decay exp(0) = 1, zero input)."""
    h = x.shape[1]
    hpg = h // B.shape[1]
    xf, dtf = x.float(), dt.float()
    Bx = B.float().repeat_interleave(hpg, dim=1)
    Cx = C.float().repeat_interleave(hpg, dim=1)
    decay = torch.exp(dtf * A[None, :])[..., None, None]
    state = state * decay + (dtf[..., None] * Bx)[..., None] * xf[..., None, :]
    y = torch.einsum("bhs,bhsd->bhd", Cx, state)
    if D is not None:
        y = y + D[None, :, None] * xf
    return y.to(x.dtype), state
