"""Meta-tensor stand-ins for every model input: the dry run's currency
(the port of ``repro.launch.specs``, meta tensors in place of
``jax.ShapeDtypeStruct``).

Shape and dtype only, no allocation.  ``input_specs`` returns the
arguments of the step function selected by the shape's kind:

* train  -> train_step(state, batch)
* prefill -> prefill(params, cache_empty, tokens)
* decode  -> decode_step(params, cache_full, tokens_1)

The kinds, keys and shapes are the reference's; the dtypes are their
torch counterparts.  The caches are the one-process caches the model's
own ``init_cache`` builds on ``"meta"``, so they carry the port's layout
(a sink position past each ring, ``models.common``) and the parameters
the port's per-layer lists (``distributed.sharding`` maps both onto the
reference's stacked leaves).
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig
from repro_torch.device import torch_dtype


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(int(s) for s in shape), dtype=dtype,
                       device="meta")


def batch_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict[str, Any]:
    b, s = shape.global_batch, shape.seq_len
    batch = {
        "tokens": _meta((b, s), torch.int32),
        "labels": _meta((b, s), torch.int32),
    }
    dt = torch_dtype(cfg.dtype)
    if cfg.family == "vlm":
        batch["vis"] = _meta((b, cfg.n_vis_tokens, cfg.d_model), dt)
    if cfg.family == "encdec":
        batch["frames"] = _meta((b, min(cfg.enc_seq, s), cfg.d_model), dt)
    return batch


def cache_shape(model, cfg: ModelConfig, batch: int, max_len: int):
    """The serving cache on ``"meta"`` from ``model.init_cache`` (``model``
    built on ``"meta"``), and the source kwargs it took."""
    kwargs = {}
    dt = torch_dtype(cfg.dtype)
    if cfg.family == "vlm":
        kwargs["vis"] = _meta((batch, cfg.n_vis_tokens, cfg.d_model), dt)
    if cfg.family == "encdec":
        kwargs["frames"] = _meta((batch, min(cfg.enc_seq, max_len),
                                  cfg.d_model), dt)
    params = model.init(None)
    cache = model.init_cache(params, batch=batch, max_len=max_len, **kwargs)
    return cache, kwargs


def input_specs(arch: str, shape_name: str, model=None, cfg=None,
                smoke: bool = False) -> dict[str, Any]:
    """All the meta tensors the cell's step function takes (the one-process
    shapes; ``model``, if given, built on ``"meta"``)."""
    from repro_torch.models import build_model, get_config
    from repro_torch.train.step import init_train_state

    cfg = cfg or get_config(arch, smoke=smoke)
    model = model or build_model(cfg, "meta")
    shape = SHAPES[shape_name]
    state = init_train_state(model, None)
    if shape.kind == "train":
        return {"kind": "train", "state": state,
                "batch": batch_specs(cfg, shape)}
    b = shape.global_batch
    cache, extra = cache_shape(model, cfg, b, shape.seq_len)
    s = shape.seq_len if shape.kind == "prefill" else 1
    # decode: one new token against a full cache of seq_len.
    return {"kind": shape.kind, "params": state["params"], "cache": cache,
            "tokens": _meta((b, s), torch.int32), "extras": extra}
