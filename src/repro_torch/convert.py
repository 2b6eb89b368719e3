"""Parameters for the port: bridged from the JAX package, or drawn anew.

``from_jax`` takes the reference's parameter pytree as numpy arrays (or
anything ``numpy.asarray`` accepts) and returns the port's: the same
layouts leaf for leaf (``wq (d, hq, dh)``, ``wo (hq, dh, d)``, the QKV
biases, ``embed.tok`` and ``embed.unembed``; a Mamba-2 layer's ``{"ln",
"mamba": {in_proj, conv_w, conv_b, dt_bias, A_log, D, norm_w,
out_proj}}``), with the stacked ``layers`` leaves (leading ``L`` axis)
split into a per-layer list and the hybrid's ``shared`` block (not
stacked) carried whole.  Each leaf keeps its dtype (the Mamba-2 fp32
leaves stay fp32 in a bf16 model); bfloat16 leaves cross through float32,
which is exact.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device


def _leaf(x, device) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(device, torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)


def _tree(x, fn):
    if isinstance(x, dict):
        return {k: _tree(v, fn) for k, v in x.items()}
    return fn(x)


_FAMILIES = ("dense", "ssm", "hybrid")


def from_jax(params, cfg: ModelConfig, device=None):
    """The reference's dense, Mamba-2 or Zamba2 params -> the port's, on
    ``device``."""
    if cfg.family not in _FAMILIES or "layers" not in params:
        raise NotImplementedError(
            f"from_jax bridges the {', '.join(_FAMILIES)} families only, "
            f"got {cfg.family!r}")
    device = resolve_device(device)
    stacked = _tree(params["layers"], np.asarray)
    out = {
        "embed": _tree(params["embed"], lambda x: _leaf(x, device)),
        "ln_f": _tree(params["ln_f"], lambda x: _leaf(x, device)),
        "layers": [
            _tree(stacked, lambda x, i=i: _leaf(x[i], device))
            for i in range(cfg.n_layers)
        ],
    }
    if cfg.family == "hybrid":
        out["shared"] = _tree(params["shared"], lambda x: _leaf(x, device))
    return out


def init(cfg: ModelConfig, generator: torch.Generator, device=None):
    """Random parameters drawn on ``device`` from ``generator`` with the
    reference init's distributions (used where no JAX run is possible)."""
    from repro_torch.models import build_model

    return build_model(cfg, device).init(generator)
