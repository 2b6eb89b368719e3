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

``train_state_from_jax`` carries the reference's whole train state across
(its ``mu``/``nu`` unstacked like the params), and ``to_jax_layout`` goes
the other way for any tree shaped like the port's params (params, grads,
moments): the per-layer lists stacked back into the reference's leading
axes, as numpy, so the tests compare leaf by leaf.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.utils.tree import leaves as tree_leaves


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


def train_state_from_jax(state, cfg: ModelConfig, device=None):
    """The reference's ``{"params", "opt": {"mu", "nu", "count"}}`` -> the
    port's train state on ``device``, the params requiring grad."""
    device = resolve_device(device)
    params = from_jax(state["params"], cfg, device)
    for p in tree_leaves(params):
        p.requires_grad_(True)
    o = state["opt"]
    return {"params": params,
            "opt": {"mu": from_jax(o["mu"], cfg, device),
                    "nu": from_jax(o["nu"], cfg, device),
                    "count": torch.tensor(int(np.asarray(o["count"])),
                                  dtype=torch.int32, device=device)}}


def _numpy(t) -> np.ndarray:
    """A copy (a CPU tensor's ``.numpy()`` would alias a leaf that the
    optimizer updates in place)."""
    t = t.detach().cpu()
    return np.array((t.float() if t.dtype == torch.bfloat16 else t).numpy())


def _stack(x):
    """Nested per-layer lists of subtrees -> one subtree of stacked numpy
    arrays (one leading axis a list level)."""
    if isinstance(x, list):
        return _stack_trees([_stack(v) for v in x])
    return _tree(x, _numpy)


def _stack_trees(trees):
    """Same-structured numpy trees -> one tree, leaves stacked on axis 0."""
    if isinstance(trees[0], dict):
        return {k: _stack_trees([t[k] for t in trees]) for k in trees[0]}
    return np.stack(trees)


def to_jax_layout(tree, cfg: ModelConfig) -> dict:
    """A tree shaped like the port's params of ``cfg`` (params, their
    gradients, AdamW moments) -> the reference's layout as numpy: stacked
    layer subtrees, bf16 leaves as float32 (exact)."""
    if cfg.family not in _FAMILIES:
        raise ValueError(f"to_jax_layout: unknown family {cfg.family!r}")
    return {key: _stack(tree[key]) for key in _FAMILIES[cfg.family]}
