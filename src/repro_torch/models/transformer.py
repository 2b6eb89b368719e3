"""Decoder-only transformer LM: dense GQA, MoE and the VLM with
interleaved cross-attention to stub vision-patch embeddings (the port of
``repro.models.transformer``: training's ``forward``/``loss`` and the
serving path).

Parameters are plain dicts of tensors in the reference's layouts, with
``params["layers"]`` a list of per-layer dicts (the reference stacks them
on a leading axis for ``lax.scan``; here a Python loop walks the layers).
A VLM (``cfg.cross_attn_every``) has instead ``self_layers``, g lists of
``cross_attn_every - 1`` layers, ``cross_layers`` (attention + MLP, never
MoE), one closing each group, and ``vis_proj``.  The KV cache stacks
layers on leading axes ((L,) or, for the VLM's self pool, (g, span)), and
each layer's buffers are views of it, updated in place.  The VLM's cross
K/V, one (b, n_vis, hkv, dh) pair a cross layer, are computed from the
projected vision tokens when the cache is made (``fill_source``) and only
read after.

``forward`` walks the layers with no cache; the activation policy wraps
each layer's body (a VLM: each group's span of self layers and its cross
layer), as the reference's remat wraps its scan body.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.remat import RematPolicy, apply_remat
from repro_torch.device import torch_dtype
from repro_torch.models import common as cm


def _layer_init(gen, cfg: ModelConfig, device, cross: bool = False,
                tp=None, path: tuple = (), lead: tuple = ()):
    """One layer's parameters; under ``tp`` each leaf is cut to this
    rank's block as it is drawn (``path`` the layer's place in the tree,
    ``lead`` the list lengths above it)."""
    def kw(sub):
        return {"place": cm.placer(tp, path + (sub,), lead)}

    p = {
        "ln1": cm.norm_init(cfg, device),
        "attn": cm.attn_init(gen, cfg, device, **kw("attn")),
        "ln2": cm.norm_init(cfg, device),
    }
    if cfg.family == "moe" and not cross:
        p["moe"] = cm.moe_init(gen, cfg, device, **kw("moe"))
    else:
        p["mlp"] = cm.mlp_init(gen, cfg, device, **kw("mlp"))
    return p


def init(gen: torch.Generator, cfg: ModelConfig, device, tp=None):
    """Random parameters from the reference's distributions (not its
    numbers: torch and JAX generators differ).  With ``tp`` (a
    ``ModelParallel``) every leaf is drawn whole, in the one-process
    order, and only this rank's block of it is kept: the parameters are
    the blocks of the one-process ``init``'s from the same generator
    state, and no rank holds more than one whole leaf at a time."""
    params = {"embed": cm.embed_init_params(
                  gen, cfg, device, place=cm.placer(tp, ("embed",))),
              "ln_f": cm.norm_init(cfg, device)}
    if cfg.cross_attn_every:
        g, span = _groups(cfg)
        params["self_layers"] = [
            [_layer_init(gen, cfg, device, tp=tp,
                         path=("self_layers", i, j), lead=(g, span))
             for j in range(span)] for i in range(g)]
        params["cross_layers"] = [
            _layer_init(gen, cfg, device, cross=True, tp=tp,
                        path=("cross_layers", i), lead=(g,))
            for i in range(g)]
        params["vis_proj"] = cm.placer(tp, ())("vis_proj", cm.dense_init(
            gen, (cfg.d_model, cfg.d_model), cfg.d_model,
            torch_dtype(cfg.dtype), device))
    else:
        params["layers"] = [
            _layer_init(gen, cfg, device, tp=tp, path=("layers", i),
                        lead=(cfg.n_layers,))
            for i in range(cfg.n_layers)]
    return params


def _groups(cfg: ModelConfig) -> tuple[int, int]:
    """A VLM's (groups, self layers a group): each group is ``span`` self
    layers then one cross layer."""
    return (cfg.n_layers // cfg.cross_attn_every, cfg.cross_attn_every - 1)


def _self_block_aux(p, x, cfg: ModelConfig, positions, cache=None,
                    seg_lens=None, density_mean=None, tp=None):
    """One self-attention layer -> (x, the MoE layer's aux loss, None for
    a dense layer)."""
    x = x + cm.apply_attn(p["attn"], cm.apply_norm(p["ln1"], x, cfg), cfg,
                          positions, cache, seg_lens=seg_lens, tp=tp)
    h = cm.apply_norm(p["ln2"], x, cfg)
    if "moe" in p:
        m, aux = cm.apply_moe(p["moe"], h, cfg, density_mean, tp=tp)
    else:
        m, aux = cm.apply_mlp(p["mlp"], h, cfg, tp=tp), None
    return x + m, aux


def _self_block(p, x, cfg: ModelConfig, positions, cache, seg_lens=None):
    return _self_block_aux(p, x, cfg, positions, cache, seg_lens)[0]


def _cross_block(p, x, cfg: ModelConfig, positions, vis, cache, tp=None):
    x = x + cm.apply_attn(p["attn"], cm.apply_norm(p["ln1"], x, cfg), cfg,
                          positions, cache, kv_src=vis, causal=False,
                          use_rope=False, tp=tp)
    return x + cm.apply_mlp(p["mlp"], cm.apply_norm(p["ln2"], x, cfg), cfg,
                            tp=tp)


def _stack_nocache(params, x, cfg: ModelConfig, positions, vis,
                   remat: RematPolicy, density_mean=None, tp=None):
    """The training stack: every layer over the whole block, no cache;
    -> (x, the MoE layers' summed aux loss).  A remat recompute calls
    ``density_mean`` again (on every rank alike)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.cross_attn_every:
        def group_body(h, self_layers, cross_layer, vis):
            for lp in self_layers:       # the VLM family has no MoE
                h = _self_block_aux(lp, h, cfg, positions, tp=tp)[0]
            return _cross_block(cross_layer, h, cfg, positions, vis, None,
                                tp)

        body = apply_remat(group_body, remat)
        for group, cross in zip(params["self_layers"],
                                params["cross_layers"]):
            x = body(x, group, cross, vis)
        return x, aux

    def layer_body(h, lp):
        return _self_block_aux(lp, h, cfg, positions,
                               density_mean=density_mean, tp=tp)

    body = apply_remat(layer_body, remat)
    for lp in params["layers"]:
        x, da = body(x, lp)
        if da is not None:
            aux = aux + da
    return x, aux


def _stack_cached(params, x, cfg: ModelConfig, positions, cache,
                  seg_lens=None):
    """Loop over layers threading each layer's KV buffers (views of the
    stacked cache, written in place).  ``cache["lengths"]`` is the (b,)
    ragged cursor shared by every layer.  A VLM runs its groups: ``span``
    self layers over the (g, span) pool, then the group's cross layer over
    its fixed-source K/V."""
    lengths = cache["lengths"]
    pages = cache.get("pages")

    def self_kv(kv, *at):
        lc = {"k": kv["k"][at], "v": kv["v"][at], "lengths": lengths}
        if pages is not None:
            lc["pages"] = pages
        return lc

    if cfg.cross_attn_every:
        layers = cache["layers"]
        cross = layers["cross"]
        for gi, group in enumerate(params["self_layers"]):
            for j, lp in enumerate(group):
                x = _self_block(lp, x, cfg, positions,
                                self_kv(layers["self"], gi, j),
                                seg_lens=seg_lens)
            x = _cross_block(params["cross_layers"][gi], x, cfg, positions,
                             cache["vis"], {"k": cross["k"][gi],
                                            "v": cross["v"][gi]})
    else:
        for i, lp in enumerate(params["layers"]):
            x = _self_block(lp, x, cfg, positions,
                            self_kv(cache["layers"], i), seg_lens=seg_lens)
    new_cache = dict(cache)
    new_cache["lengths"] = (
        lengths + (x.shape[1] if seg_lens is None else seg_lens)
    ).to(torch.int32)
    return x, new_cache


def init_cache(params, cfg: ModelConfig, batch: int, max_len: int,
               n_pages=None, *, device, vis=None):
    """Contiguous ring (L, b, max_len + 1, hkv, dh) or paged pool
    (L, N + 1, page_size, hkv, dh) plus table; the extra unit is the sink
    of dropped rows (models.common).  A VLM's self pool has lead axes
    (g, span), and ``vis`` (b, n_vis, d) gives its cross K/V
    (g, b, n_vis, hkv, dh) and the projected ``"vis"`` leaf."""
    hkv, dh = cfg.n_kv_heads, cfg.head_dim_
    dt = torch_dtype(cfg.dtype)
    lead = _groups(cfg) if cfg.cross_attn_every else (cfg.n_layers,)
    cache = {"lengths": torch.zeros(batch, dtype=torch.int32, device=device)}
    if cfg.cache_layout == "paged":
        kv, pages = cm.paged_kv_buffers(lead, batch, max_len, cfg, n_pages,
                                        device=device)
        cache["pages"] = pages
    else:
        shape = (*lead, batch, max_len + 1, hkv, dh)
        kv = {"k": torch.zeros(shape, dtype=dt, device=device),
              "v": torch.zeros(shape, dtype=dt, device=device)}
    if not cfg.cross_attn_every:
        cache["layers"] = kv
        return cache
    if vis is None:
        raise ValueError("a VLM cache needs the vision tokens (vis=)")
    g = lead[0]
    t = vis.shape[1]
    shape = (g, batch, t, hkv, dh)
    cache["layers"] = {
        "self": kv,
        "cross": {"k": torch.empty(shape, dtype=dt, device=device),
                  "v": torch.empty(shape, dtype=dt, device=device)}}
    cache["vis"] = torch.empty((batch, t, cfg.d_model), dtype=dt,
                               device=device)
    fill_source(params, cache, cfg, vis=vis)
    return cache


def fill_source(params, cache, cfg: ModelConfig, vis):
    """Write the VLM's fixed-source leaves in place: ``"vis"`` = vis @
    vis_proj and each cross layer's K/V (plus the QKV bias when
    ``cfg.qkv_bias``), the reference's init_cache arithmetic."""
    dt = torch_dtype(cfg.dtype)
    d, hkv, dh = cfg.d_model, cfg.n_kv_heads, cfg.head_dim_
    visp = cache["vis"]
    visp.copy_(vis.to(device=visp.device, dtype=dt) @ params["vis_proj"])
    b, t = visp.shape[:2]
    cross = cache["layers"]["cross"]
    for gi, lp in enumerate(params["cross_layers"]):
        a = lp["attn"]
        for key in ("k", "v"):
            kv = (visp @ a["w" + key].reshape(d, hkv * dh)).reshape(
                b, t, hkv, dh)
            if cfg.qkv_bias:
                kv = kv + a["b" + key]
            cross[key][gi].copy_(kv)


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


def _hidden(params, tokens, cfg: ModelConfig, vis, remat: RematPolicy,
            density_mean, tp):
    """The final normed hidden states (b, s, d) and the aux loss."""
    s = tokens.shape[1]
    x = cm.embed(params["embed"], tokens, tp)
    if cfg.cross_attn_every:
        if vis is None:
            raise ValueError("a VLM forward needs the vision tokens (vis=)")
        vis = vis.to(device=x.device, dtype=x.dtype)
        w = params["vis_proj"]
        if w.shape[1] != cfg.d_model:        # column-split over ``model``
            # Every rank's cross layers read the whole projected tokens.
            vis = tp.gather(tp.copy(vis) @ w, -1)
        else:
            vis = vis @ w
    positions = torch.arange(s, device=tokens.device)[None, :]
    x, aux = _stack_nocache(params, x, cfg, positions, vis, remat,
                            density_mean, tp)
    return cm.apply_norm(params["ln_f"], x, cfg), aux


def forward(params, tokens, cfg: ModelConfig, vis=None,
            remat: RematPolicy = RematPolicy.SAVE_DOTS, density_mean=None,
            tp=None):
    """tokens (b, s) -> (logits (b, s, padded vocab), aux loss);
    ``density_mean``: see ``common._route``.  Under ``tp`` the logits are
    gathered whole on every rank, as the reference's forward returns
    them."""
    x, aux = _hidden(params, tokens, cfg, vis, remat, density_mean, tp)
    logits = cm.unembed(params["embed"], x, cfg, tp)
    return cm.gather_vocab(logits, tp), aux


def loss_fn(params, batch, cfg: ModelConfig,
            remat: RematPolicy = RematPolicy.SAVE_DOTS, density_mean=None,
            tp=None):
    """Mean CE + aux; under ``tp`` the vocab-parallel loss over this
    rank's logit columns (never gathered)."""
    x, aux = _hidden(params, batch["tokens"], cfg, batch.get("vis"), remat,
                     density_mean, tp)
    logits = cm.unembed(params["embed"], x, cfg, tp)
    ce = cm.cross_entropy(logits, batch["labels"], cfg.vocab, tp)
    return ce + aux, {"ce": ce, "aux": aux}


def build(cfg: ModelConfig, device: torch.device, tp=None) -> cm.ModelApply:
    """``tp`` (a ``distributed.tensor_parallel.ModelParallel``) binds
    tensor and expert parallel execution into ``init``, ``forward`` and
    ``loss`` (dense, MoE and VLM families); the cache entry points then
    refuse."""
    vlm = bool(cfg.cross_attn_every)
    if tp is not None:
        return cm.ModelApply(
            config=cfg,
            init=functools.partial(init, cfg=cfg, device=device, tp=tp),
            forward=functools.partial(forward, cfg=cfg, tp=tp),
            loss=functools.partial(loss_fn, cfg=cfg, tp=tp),
            init_cache=cm.single_rank, prefill=cm.single_rank,
            decode_step=cm.single_rank,
            fill_source=cm.single_rank if vlm else None)
    return cm.ModelApply(
        config=cfg,
        init=functools.partial(init, cfg=cfg, device=device),
        forward=functools.partial(forward, cfg=cfg),
        loss=functools.partial(loss_fn, cfg=cfg),
        init_cache=functools.partial(init_cache, cfg=cfg, device=device),
        prefill=functools.partial(prefill, cfg=cfg),
        decode_step=functools.partial(decode_step, cfg=cfg),
        reset_slots=cm.reset_lengths,
        kv_pool=("layers", "self") if vlm else ("layers",),
        fill_source=functools.partial(fill_source, cfg=cfg) if vlm else None,
    )
