"""Parameters for the port: bridged from the JAX package, or drawn anew.

``from_jax`` takes the reference's parameter pytree as numpy arrays (or
anything ``numpy.asarray`` accepts) and returns the port's: the same
layouts leaf for leaf (``wq (d, hq, dh)``, ``wo (hq, dh, d)``, the QKV
biases, ``embed.tok`` and ``embed.unembed``; a Mamba-2 layer's ``{"ln",
"mamba": {in_proj, conv_w, conv_b, dt_bias, A_log, D, norm_w,
out_proj}}``; an MoE layer's ``moe: {router, wg, wu, wd}``), with the
stacked ``layers`` leaves (leading ``L`` axis) split into a per-layer list
and the hybrid's ``shared`` block (not stacked) carried whole.  whisper's
stacked ``enc_layers`` and ``dec_layers`` become per-layer lists beside
``dec_pos`` and ``ln_enc``; the VLM's ``self_layers`` (g, span, ...) become
g lists of span layers, its ``cross_layers`` (g, ...) a list, beside
``vis_proj``.  Each leaf keeps its dtype (the Mamba-2 fp32
leaves and the MoE router stay fp32 in a bf16 model); bfloat16 leaves
cross through float32, which is exact.
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


def _unstack(stacked, dims: tuple, device):
    """A stacked subtree (leading axes ``dims``) as nested lists of
    subtrees, one list level an axis."""
    if not dims:
        return _tree(stacked, lambda x: _leaf(x, device))
    return [_unstack(_tree(stacked, lambda x, i=i: x[i]), dims[1:], device)
            for i in range(dims[0])]


# The top-level entries each family's parameters hold; the stacked layer
# subtrees among them are split along their leading axes.
_FAMILIES = {
    "dense": ("embed", "ln_f", "layers"),
    "moe": ("embed", "ln_f", "layers"),
    "ssm": ("embed", "ln_f", "layers"),
    "hybrid": ("embed", "ln_f", "layers", "shared"),
    "encdec": ("embed", "dec_pos", "enc_layers", "dec_layers", "ln_enc",
               "ln_f"),
    "vlm": ("embed", "ln_f", "self_layers", "cross_layers", "vis_proj"),
}


def _stack_dims(cfg: ModelConfig) -> dict:
    g = cfg.n_layers // max(cfg.cross_attn_every, 1)
    return {"layers": (cfg.n_layers,), "dec_layers": (cfg.n_layers,),
            "enc_layers": (cfg.enc_layers,),
            "self_layers": (g, cfg.cross_attn_every - 1),
            "cross_layers": (g,)}


def from_jax(params, cfg: ModelConfig, device=None):
    """The reference's params of any family the port serves -> the
    port's, on ``device``."""
    if cfg.family not in _FAMILIES:
        raise ValueError(f"from_jax: unknown family {cfg.family!r}")
    device = resolve_device(device)
    dims = _stack_dims(cfg)
    return {key: _unstack(_tree(params[key], np.asarray), dims.get(key, ()),
                          device)
            for key in _FAMILIES[cfg.family]}


def init(cfg: ModelConfig, generator: torch.Generator, device=None):
    """Random parameters drawn on ``device`` from ``generator`` with the
    reference init's distributions (used where no JAX run is possible)."""
    from repro_torch.models import build_model

    return build_model(cfg, device).init(generator)
