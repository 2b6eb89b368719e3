"""Device selection shared by the port's entry points."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names one.

    ``None`` means the CUDA card; without one this raises instead of
    carrying on quietly on the CPU (pass ``device="cpu"`` for that)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the card by default; "
                "pass device='cpu' to run on the CPU"
            )
        return torch.device("cuda")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is unavailable")
    return device


_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def torch_dtype(name: str) -> torch.dtype:
    """``ModelConfig.dtype`` string -> torch dtype."""
    return _DTYPES[name]


def dtype_name(dtype: torch.dtype) -> str:
    """torch dtype -> the name the JAX package gives it (``"bfloat16"``),
    the inverse of :func:`torch_dtype`.  The policy engine sizes operands
    with ``hw.dtype_bytes``, which does not know ``str(torch.bfloat16)``
    (``"torch.bfloat16"``), and its plan-cache fingerprints hold the name,
    so the port plans with the reference's names."""
    for name, t in _DTYPES.items():
        if t == dtype:
            return name
    raise ValueError(f"no planner name for {dtype}: expected one of "
                     f"{sorted(map(str, _DTYPES.values()))}")
