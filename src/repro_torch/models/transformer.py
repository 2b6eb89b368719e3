"""Decoder-only transformer LM, dense GQA and MoE families (the serving
path of ``repro.models.transformer``).

Parameters are plain dicts of tensors in the reference's layouts, with
``params["layers"]`` a list of per-layer dicts (the reference stacks them
on a leading axis for ``lax.scan``; here a Python loop walks the layers).
The KV cache stacks layers on a leading axis, and each layer's buffers are
views of it, updated in place.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import torch_dtype
from repro_torch.models import common as cm


def _layer_init(gen, cfg: ModelConfig, device):
    p = {
        "ln1": cm.norm_init(cfg, device),
        "attn": cm.attn_init(gen, cfg, device),
        "ln2": cm.norm_init(cfg, device),
    }
    if cfg.family == "moe":
        p["moe"] = cm.moe_init(gen, cfg, device)
    else:
        p["mlp"] = cm.mlp_init(gen, cfg, device)
    return p


def init(gen: torch.Generator, cfg: ModelConfig, device):
    """Random parameters from the reference's distributions (not its
    numbers: torch and JAX generators differ)."""
    return {
        "embed": cm.embed_init_params(gen, cfg, device),
        "ln_f": cm.norm_init(cfg, device),
        "layers": [_layer_init(gen, cfg, device) for _ in range(cfg.n_layers)],
    }


def _self_block(p, x, cfg: ModelConfig, positions, cache, seg_lens=None):
    x = x + cm.apply_attn(p["attn"], cm.apply_norm(p["ln1"], x, cfg), cfg,
                          positions, cache, seg_lens=seg_lens)
    h = cm.apply_norm(p["ln2"], x, cfg)
    if "moe" in p:
        m, _ = cm.apply_moe(p["moe"], h, cfg)    # aux loss: training only
    else:
        m = cm.apply_mlp(p["mlp"], h, cfg)
    return x + m


def _stack_cached(params, x, cfg: ModelConfig, positions, cache,
                  seg_lens=None):
    """Loop over layers threading each layer's KV buffers (views of the
    stacked cache, written in place).  ``cache["lengths"]`` is the (b,)
    ragged cursor shared by every layer."""
    lengths = cache["lengths"]
    pages = cache.get("pages")
    layers = cache["layers"]
    for i, lp in enumerate(params["layers"]):
        lc = {"k": layers["k"][i], "v": layers["v"][i], "lengths": lengths}
        if pages is not None:
            lc["pages"] = pages
        x = _self_block(lp, x, cfg, positions, lc, seg_lens=seg_lens)
    new_cache = dict(cache)
    new_cache["lengths"] = (
        lengths + (x.shape[1] if seg_lens is None else seg_lens)
    ).to(torch.int32)
    return x, new_cache


def init_cache(params, cfg: ModelConfig, batch: int, max_len: int,
               n_pages=None, *, device):
    """Contiguous ring (L, b, max_len + 1, hkv, dh) or paged pool
    (L, N + 1, page_size, hkv, dh) plus table; the extra unit is the sink
    of dropped rows (models.common)."""
    del params
    L, hkv, dh = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim_
    cache = {"lengths": torch.zeros(batch, dtype=torch.int32, device=device)}
    if cfg.cache_layout == "paged":
        kv, pages = cm.paged_kv_buffers((L,), batch, max_len, cfg, n_pages,
                                        device=device)
        cache["pages"] = pages
    else:
        shape = (L, batch, max_len + 1, hkv, dh)
        dt = torch_dtype(cfg.dtype)
        kv = {"k": torch.zeros(shape, dtype=dt, device=device),
              "v": torch.zeros(shape, dtype=dt, device=device)}
    cache["layers"] = kv
    return cache


def prefill(params, cache, tokens, cfg: ModelConfig, seg_lens=None,
            all_logits=False):
    s = tokens.shape[1]
    x = cm.embed(params["embed"], tokens)
    positions = (cache["lengths"][:, None]
                 + torch.arange(s, device=tokens.device)[None, :])
    x, new_cache = _stack_cached(params, x, cfg, positions, cache,
                                 seg_lens=seg_lens)
    x = cm.apply_norm(params["ln_f"], x, cfg)
    out = x if all_logits else cm.last_valid_slice(x, seg_lens)
    return cm.unembed(params["embed"], out, cfg), new_cache


def decode_step(params, cache, tokens, cfg: ModelConfig, seg_lens=None):
    return prefill(params, cache, tokens, cfg, seg_lens=seg_lens)


def build(cfg: ModelConfig, device: torch.device) -> cm.ModelApply:
    return cm.ModelApply(
        config=cfg,
        init=functools.partial(init, cfg=cfg, device=device),
        init_cache=functools.partial(init_cache, cfg=cfg, device=device),
        prefill=functools.partial(prefill, cfg=cfg),
        decode_step=functools.partial(decode_step, cfg=cfg),
        reset_slots=cm.reset_lengths,
    )
