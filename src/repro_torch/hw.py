"""Hardware model constants and roofline math for the policy engine.

A copy of ``repro.hw`` (pure Python) with one addition, ``H100``: the
card the port runs on.  ``Chip`` names its fields after the TPU
(``vmem_bytes``, ``mxu_dim``, ``ici_*``); for a GPU they mean the cache
the planner may claim for residency (the L2, as ``PAPER_GPU`` already
reads it), the tensor-core tile edge, and the interconnect.  The
constants drive the analytical cost model and the residency allocator of
``repro_torch.core``; the CPU tests plan for every model here.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Chip:
    """One TPU chip (v5e by default)."""

    name: str = "tpu-v5e"
    # Compute
    peak_flops_bf16: float = 197e12     # FLOP/s
    peak_flops_fp32: float = 197e12 / 4  # no fp32 MXU path; conservative
    mxu_dim: int = 128                  # systolic array is 128x128
    vpu_lanes: int = 8 * 128            # (8, 128) vector registers
    # Memory
    hbm_bytes: int = 16 * 1024**3       # 16 GB
    hbm_bw: float = 819e9               # B/s
    vmem_bytes: int = 128 * 1024 * 1024  # 128 MB software-managed scratchpad
    # Interconnect
    ici_bw_per_link: float = 50e9       # B/s per ICI link (per direction)
    ici_links: int = 4                  # 2D torus on v5e: 4 links/chip
    # DMA / burst granularity used by the rinse (write-contiguity) model.
    hbm_burst_bytes: int = 512
    # Fraction of VMEM the planner may claim (leave headroom for compiler
    # temporaries / semaphores / double-buffer bookkeeping).
    vmem_budget_frac: float = 0.75

    @property
    def vmem_budget(self) -> int:
        return int(self.vmem_bytes * self.vmem_budget_frac)

    @property
    def ridge_intensity_bf16(self) -> float:
        """FLOP/byte at which compute and HBM time balance."""
        return self.peak_flops_bf16 / self.hbm_bw


V5E = Chip()

# Calibrated model of the paper's simulated system (Table 1): 64-CU GCN3 APU,
# ~12.3 TFLOP/s fp32, HBM2 @ 512 GB/s, 4 MB GPU L2 (the "cache capacity" that
# plays VMEM's role in the reproduction benches), 2 KB DRAM rows.
PAPER_GPU = Chip(
    name="gem5-apu",
    peak_flops_bf16=12.3e12,   # single-rate fp32 machine; bf16 field = fp32 rate
    peak_flops_fp32=12.3e12,
    mxu_dim=64,                # wavefront/LDS tile granularity
    vpu_lanes=64,
    hbm_bytes=16 * 1024**3,
    hbm_bw=512e9,
    vmem_bytes=4 * 1024 * 1024,  # GPU L2 as the residency capacity
    ici_bw_per_link=0.0,
    ici_links=1,
    hbm_burst_bytes=2048,      # DRAM row-buffer granule
    vmem_budget_frac=0.9,
)

# NVIDIA H100 SXM from its data sheet (dense tensor-core rates).  The
# residency capacity is the 50 MB L2, not a CTA's 227 KB of shared memory:
# the policy question the planner answers is which operands stay cached
# across a kernel's tile sweep, and on the card that cache is the L2 (with
# 227 KB the planner would shrink matmul windows to 64 x 128 x 128 and the
# decode plan to 8-token KV blocks).  mxu_dim 64 is wgmma's M, the
# smallest tile edge that keeps the tensor cores fed; hbm_burst_bytes 128
# is the L2 line (four 32-byte sectors) that one DRAM transfer fills.
H100 = Chip(
    name="h100",
    peak_flops_bf16=989e12,
    peak_flops_fp32=67e12,     # CUDA cores, no TF32
    mxu_dim=64,
    vpu_lanes=32,              # a warp
    hbm_bytes=80 * 1024**3,    # 80 GB HBM3
    hbm_bw=3.35e12,
    vmem_bytes=50 * 1024 * 1024,  # L2 as the residency capacity
    ici_bw_per_link=25e9,      # NVLink 4: 18 links, 25 GB/s each way each
    ici_links=18,
    hbm_burst_bytes=128,
    vmem_budget_frac=0.75,
)

# Default pod geometry for this project (see launch/mesh.py).
PODS = 2
CHIPS_PER_POD = 256          # 16 x 16
POD_MESH = (16, 16)          # (data, model)
MULTIPOD_MESH = (2, 16, 16)  # (pod, data, model)

DTYPE_BYTES = {
    "float32": 4, "f32": 4,
    "bfloat16": 2, "bf16": 2,
    "float16": 2, "f16": 2,
    "float64": 8, "f64": 8,
    "int8": 1, "s8": 1, "u8": 1,
    "int32": 4, "s32": 4, "u32": 4,
    "int64": 8, "s64": 8, "u64": 8,
    "bool": 1, "pred": 1,
}


def dtype_bytes(dtype) -> int:
    """Bytes per element for a numpy/jax dtype or short HLO name."""
    s = str(dtype)
    if s in DTYPE_BYTES:
        return DTYPE_BYTES[s]
    import numpy as np

    return np.dtype(dtype).itemsize


def flops_time(flops: float, chip: Chip = V5E, dtype: str = "bf16") -> float:
    peak = chip.peak_flops_bf16 if dtype_bytes(dtype) <= 2 else chip.peak_flops_fp32
    return flops / peak


def hbm_time(num_bytes: float, chip: Chip = V5E) -> float:
    return num_bytes / chip.hbm_bw


def ici_time(num_bytes: float, chip: Chip = V5E, links: int | None = None) -> float:
    links = chip.ici_links if links is None else links
    return num_bytes / (chip.ici_bw_per_link * links)
