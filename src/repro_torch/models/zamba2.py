"""Zamba2-style hybrid: a Mamba-2 backbone plus ONE shared attention block
applied after every k SSM layers, the port of ``repro.models.zamba2``
(arXiv:2411.15242): training's ``forward``/``loss`` and the serving path.

The reference's simplifications are kept (DESIGN.md §5): the shared block
works at d_model and has no per-invocation LoRA deltas.  Its weights are
shared; each of the ``n_layers / k`` invocations has its own KV cache,
stacked on a leading (g,) axis: a contiguous ring (g, b, max_len + 1, hkv,
dh) or a paged pool (g, N + 1, page_size, hkv, dh) with one page table for
all invocations (the extra unit is the sink of dropped rows,
``models.common``).  The reference's ``_group_view`` reshape becomes index
arithmetic: group i runs layers i*k .. i*k + k - 1, then the shared block
over KV cache i.  ``forward`` runs the same groups with no cache, the
activation policy wrapping each group's body.

Tensor parallel over a mesh's ``model`` axis (``build(cfg, device, tp)``,
every entry point): the Mamba-2 layers as ``models.mamba2`` splits them
(each rank holds its ``sharding.param_spec`` block of every leaf and
scans its SSM heads), the shared block as the dense transformer's
(``models.common``'s split attention by heads, ``dh`` or replicated K/V,
and the column/row-split MLP), the embedding, logits and loss
vocab-parallel.  The split cache is the rank's ``sharding.cache_spec``
block: the Mamba-2 layers' as ``models.mamba2``'s, and each group's K/V
``kv`` its batch rows and block of the sequence over ``model``, every KV
head; under ``long_context`` (long_500k's one sequence) its block of the
sequence over ``data`` and its KV heads over ``model``
(``models.common._attn_split_cached``).
"""
from __future__ import annotations

import functools

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.remat import RematPolicy, apply_remat
from repro_torch.device import torch_dtype
from repro_torch.models import common as cm
from repro_torch.models import mamba2 as mb


def init(gen: torch.Generator, cfg: ModelConfig, device, tp=None):
    """Random parameters from the reference's distributions; with ``tp``
    each rank keeps its block of every leaf, drawn in the one-process
    order."""
    if cfg.shared_attn_every <= 0:
        raise ValueError("zamba2 needs shared_attn_every > 0")
    return {
        "embed": cm.embed_init_params(gen, cfg, device,
                                      place=cm.placer(tp, ("embed",))),
        "ln_f": cm.norm_init(cfg, device),
        "layers": mb.layers_init(gen, cfg, device, tp),
        # The single shared transformer block (parameters counted once).
        "shared": {
            "ln1": cm.norm_init(cfg, device),
            "attn": cm.attn_init(gen, cfg, device,
                                 place=cm.placer(tp, ("shared", "attn"))),
            "ln2": cm.norm_init(cfg, device),
            "mlp": cm.mlp_init(gen, cfg, device,
                               place=cm.placer(tp, ("shared", "mlp"))),
        },
    }


def _shared_block(p, x, cfg: ModelConfig, positions, cache, seg_lens=None,
                  tp=None):
    x = x + cm.apply_attn(p["attn"], cm.apply_norm(p["ln1"], x, cfg), cfg,
                          positions, cache, seg_lens=seg_lens, tp=tp)
    return x + cm.apply_mlp(p["mlp"], cm.apply_norm(p["ln2"], x, cfg), cfg,
                            tp=tp)


def init_cache(params, cfg: ModelConfig, batch: int, max_len: int,
               n_pages=None, *, device, tp=None):
    """The Mamba-2 layers' state (``mamba2.recurrent_buffers``) and the
    shared block's (g, ...) K/V: a contiguous ring or a paged pool.  Split
    (``tp``): this rank's block of the one-process cache for a global
    ``batch`` (the module docstring); the paged layout stays on one
    rank."""
    del params
    cm.refuse_split_paged(cfg, tp)
    g = cfg.n_layers // cfg.shared_attn_every
    cache = mb.recurrent_buffers(cfg, batch, device, tp)
    if cfg.cache_layout == "paged":
        kv, pages = cm.paged_kv_buffers((g,), batch, max_len, cfg, n_pages,
                                        device=device)
        cache["pages"] = pages
    else:
        hkv, dh = cfg.n_kv_heads, cfg.head_dim_
        shape = ((g, batch, max_len + 1, hkv, dh) if tp is None else
                 tp.ring_block("kv/k", (g,), batch, max_len, hkv, dh))
        dt = torch_dtype(cfg.dtype)
        kv = {"k": torch.zeros(shape, dtype=dt, device=device),
              "v": torch.zeros(shape, dtype=dt, device=device)}
    cache["kv"] = kv
    return cache


def prefill(params, cache, tokens, cfg: ModelConfig, seg_lens=None,
            all_logits=False, tp=None):
    """Split (``tp``): ``tokens`` and ``seg_lens`` are this rank's batch
    rows, the cache its block (:func:`init_cache`), and the logits come
    back whole on every rank."""
    s = tokens.shape[1]
    k = cfg.shared_attn_every
    x = cm.embed(params["embed"], tokens, tp)
    lengths = cache["lengths"]
    pages = cache.get("pages")
    positions = (lengths[:, None]
                 + torch.arange(s, device=tokens.device)[None, :])
    for gi in range(cfg.n_layers // k):
        for i in range(gi * k, gi * k + k):
            x = mb.mamba_layer(params["layers"][i], x, cfg, cache, i,
                               seg_lens=seg_lens, tp=tp)
        kv = {"k": cache["kv"]["k"][gi], "v": cache["kv"]["v"][gi],
              "lengths": lengths}
        if pages is not None:
            kv["pages"] = pages
        x = _shared_block(params["shared"], x, cfg, positions, kv,
                          seg_lens=seg_lens, tp=tp)
    x = cm.apply_norm(params["ln_f"], x, cfg)
    out = x if all_logits else cm.last_valid_slice(x, seg_lens)
    new_cache = dict(cache)
    new_cache["lengths"] = (
        lengths + (s if seg_lens is None else seg_lens)).to(torch.int32)
    return cm.gather_vocab(cm.unembed(params["embed"], out, cfg, tp),
                           tp), new_cache


def decode_step(params, cache, tokens, cfg: ModelConfig, seg_lens=None,
                tp=None):
    return prefill(params, cache, tokens, cfg, seg_lens=seg_lens, tp=tp)


def _logits(params, tokens, cfg: ModelConfig, remat: RematPolicy, tp):
    """The logits, this rank's vocab columns under ``tp``."""
    k = cfg.shared_attn_every
    x = cm.embed(params["embed"], tokens, tp)
    positions = torch.arange(tokens.shape[1], device=tokens.device)[None, :]

    def group_body(h, group, shared):
        for lp in group:
            h = mb.mamba_block(lp, h, cfg, tp)
        return _shared_block(shared, h, cfg, positions, None, tp=tp)

    body = apply_remat(group_body, remat)
    layers = params["layers"]
    for gi in range(cfg.n_layers // k):
        x = body(x, layers[gi * k:gi * k + k], params["shared"])
    x = cm.apply_norm(params["ln_f"], x, cfg)
    return cm.unembed(params["embed"], x, cfg, tp)


def forward(params, tokens, cfg: ModelConfig,
            remat: RematPolicy = RematPolicy.SAVE_DOTS, tp=None):
    """tokens (b, s) -> (logits, aux = 0); under ``tp`` the logits are
    gathered whole on every rank."""
    logits = _logits(params, tokens, cfg, remat, tp)
    return (cm.gather_vocab(logits, tp),
            torch.zeros((), dtype=torch.float32, device=logits.device))


def loss_fn(params, batch, cfg: ModelConfig,
            remat: RematPolicy = RematPolicy.SAVE_DOTS, tp=None):
    """Mean CE; under ``tp`` the vocab-parallel loss over this rank's
    columns."""
    logits = _logits(params, batch["tokens"], cfg, remat, tp)
    ce = cm.cross_entropy(logits, batch["labels"], cfg.vocab, tp)
    aux = torch.zeros((), dtype=torch.float32, device=logits.device)
    return ce + aux, {"ce": ce, "aux": aux}


def build(cfg: ModelConfig, device: torch.device, tp=None) -> cm.ModelApply:
    """``tp`` (a ``distributed.tensor_parallel.ModelParallel``) binds
    tensor parallel execution into every entry point: ``init``,
    ``forward`` and ``loss``, and the cache entry points on this rank's
    block of the cache (:func:`init_cache`)."""
    return cm.ModelApply(
        config=cfg,
        init=functools.partial(init, cfg=cfg, device=device, tp=tp),
        forward=functools.partial(forward, cfg=cfg, tp=tp),
        loss=functools.partial(loss_fn, cfg=cfg, tp=tp),
        init_cache=functools.partial(init_cache, cfg=cfg, device=device,
                                     tp=tp),
        prefill=functools.partial(prefill, cfg=cfg, tp=tp),
        decode_step=functools.partial(decode_step, cfg=cfg, tp=tp),
        reset_slots=cm.reset_recurrent,
        kv_pool=("kv",),
    )
