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

**FSDP** (``fs``, a ``distributed.fsdp.DataShards``): each rank holds its
``(model, data)`` block of every leaf, and ``forward``/``loss`` gather a
layer's (a VLM group's) leaves over ``data`` at the top of its body,
inside the activation policy's region, and each top-level leaf (the
embedding for the lookup, the logits' weight, ``vis_proj``, ``ln_f``)
at its use; the code after a gather is the tensor-parallel code
on the rank's ``model`` blocks.  The cache entry points refuse
(``common.fsdp_refuses_serving``).
"""
from __future__ import annotations

import functools

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.remat import RematPolicy, apply_remat
from repro_torch.device import torch_dtype
from repro_torch.distributed.fsdp import gather
from repro_torch.models import common as cm


def _layer_init(gen, cfg: ModelConfig, device, cross: bool = False,
                tp=None, path: tuple = (), lead: tuple = ()):
    """One layer's parameters; under ``tp`` each leaf is cut to this
    rank's block as it is drawn (``path`` the layer's place in the tree,
    ``lead`` the list lengths above it)."""
    def kw(sub):
        return {"place": cm.placer(tp, path + (sub,), lead)}

    # Norms too: FSDP splits a stack of them over ``data`` where it is
    # large enough (the VLM's (g, span, d) self-layer norms).
    p = {
        "ln1": cm.norm_init(cfg, device, **kw("ln1")),
        "attn": cm.attn_init(gen, cfg, device, **kw("attn")),
        "ln2": cm.norm_init(cfg, device, **kw("ln2")),
    }
    if cfg.family == "moe" and not cross:
        p["moe"] = cm.moe_init(gen, cfg, device, **kw("moe"))
    else:
        p["mlp"] = cm.mlp_init(gen, cfg, device, **kw("mlp"))
    return p


def init(gen: torch.Generator, cfg: ModelConfig, device, tp=None, fs=None):
    """Random parameters from the reference's distributions (not its
    numbers: torch and JAX generators differ).  With ``tp`` (a
    ``ModelParallel``) every leaf is drawn whole, in the one-process
    order, and only this rank's block of it is kept: the parameters are
    the blocks of the one-process ``init``'s from the same generator
    state, and no rank holds more than one whole leaf at a time.  With
    ``fs`` (FSDP) the blocks are the FSDP rule's, split over ``data``
    too."""
    tp = fs if fs is not None else tp       # whose blocks the placers keep
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


def _self_block(p, x, cfg: ModelConfig, positions, cache, seg_lens=None,
                tp=None):
    return _self_block_aux(p, x, cfg, positions, cache, seg_lens, tp=tp)[0]


def _cross_block(p, x, cfg: ModelConfig, positions, vis, cache, tp=None):
    x = x + cm.apply_attn(p["attn"], cm.apply_norm(p["ln1"], x, cfg), cfg,
                          positions, cache, kv_src=vis, causal=False,
                          use_rope=False, tp=tp)
    return x + cm.apply_mlp(p["mlp"], cm.apply_norm(p["ln2"], x, cfg), cfg,
                            tp=tp)


def _stack_nocache(params, x, cfg: ModelConfig, positions, vis,
                   remat: RematPolicy, density_mean=None, tp=None, fs=None):
    """The training stack: every layer over the whole block, no cache;
    -> (x, the MoE layers' summed aux loss).  A remat recompute calls
    ``density_mean`` again (on every rank alike), and under FSDP gathers
    the layer's leaves again."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.cross_attn_every:
        def group_body(h, self_layers, cross_layer, vis, gi):
            self_layers = gather(fs, self_layers, "self_layers", gi)
            cross_layer = gather(fs, cross_layer, "cross_layers", gi)
            for lp in self_layers:       # the VLM family has no MoE
                h = _self_block_aux(lp, h, cfg, positions, tp=tp)[0]
            return _cross_block(cross_layer, h, cfg, positions, vis, None,
                                tp)

        body = apply_remat(group_body, remat)
        for gi, (group, cross) in enumerate(zip(params["self_layers"],
                                                params["cross_layers"])):
            x = body(x, group, cross, vis, gi)
        return x, aux

    def layer_body(h, lp, i):
        return _self_block_aux(gather(fs, lp, "layers", i), h, cfg,
                               positions, density_mean=density_mean, tp=tp)

    body = apply_remat(layer_body, remat)
    for i, lp in enumerate(params["layers"]):
        x, da = body(x, lp, i)
        if da is not None:
            aux = aux + da
    return x, aux


def _stack_cached(params, x, cfg: ModelConfig, positions, cache,
                  seg_lens=None, tp=None):
    """Loop over layers threading each layer's KV buffers (views of the
    stacked cache, written in place).  ``cache["lengths"]`` is the (b,)
    ragged cursor shared by every layer.  A VLM runs its groups: ``span``
    self layers over the (g, span) pool, then the group's cross layer over
    its fixed-source K/V.  ``tp``: the split cache (:func:`init_cache`)."""
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
                                seg_lens=seg_lens, tp=tp)
            x = _cross_block(params["cross_layers"][gi], x, cfg, positions,
                             cache["vis"], {"k": cross["k"][gi],
                                            "v": cross["v"][gi]}, tp)
    else:
        for i, lp in enumerate(params["layers"]):
            x = _self_block(lp, x, cfg, positions,
                            self_kv(cache["layers"], i), seg_lens=seg_lens,
                            tp=tp)
    new_cache = dict(cache)
    new_cache["lengths"] = (
        lengths + (x.shape[1] if seg_lens is None else seg_lens)
    ).to(torch.int32)
    return x, new_cache


def init_cache(params, cfg: ModelConfig, batch: int, max_len: int,
               n_pages=None, *, device, vis=None, tp=None):
    """Contiguous ring (L, b, max_len + 1, hkv, dh) or paged pool
    (L, N + 1, page_size, hkv, dh) plus table; the extra unit is the sink
    of dropped rows (models.common).  A VLM's self pool has lead axes
    (g, span), and ``vis`` (b, n_vis, d) gives its cross K/V
    (g, b, n_vis, hkv, dh) and the projected ``"vis"`` leaf.

    Split (``tp``): this rank's ``sharding.cache_spec`` block of every
    leaf of the one-process cache for a global ``batch``, read through
    ``sharding.local_shape``: its rows of the batch (over the batch axes);
    the self K/V's block of ``max_len`` (over ``model``, or under
    ``long_context`` over ``data`` with the KV heads over ``model``),
    plus the block's own sink position; the cross K/V's KV heads where
    the rule splits them; ``"vis"`` its rows.  ``vis`` the global batch's
    or this rank's rows.  The paged layout stays on one rank."""
    cm.refuse_split_paged(cfg, tp)
    hkv, dh = cfg.n_kv_heads, cfg.head_dim_
    dt = torch_dtype(cfg.dtype)
    lead = _groups(cfg) if cfg.cross_attn_every else (cfg.n_layers,)
    path = "layers/self/k" if cfg.cross_attn_every else "layers/k"
    rows = batch if tp is None else tp.cache_rows(batch)
    cache = {"lengths": torch.zeros(rows, dtype=torch.int32, device=device)}
    if cfg.cache_layout == "paged":
        kv, pages = cm.paged_kv_buffers(lead, batch, max_len, cfg, n_pages,
                                        device=device)
        cache["pages"] = pages
    else:
        shape = ((*lead, batch, max_len + 1, hkv, dh) if tp is None else
                 tp.ring_block(path, lead, batch, max_len, hkv, dh))
        kv = {"k": torch.zeros(shape, dtype=dt, device=device),
              "v": torch.zeros(shape, dtype=dt, device=device)}
    if not cfg.cross_attn_every:
        cache["layers"] = kv
        return cache
    if vis is None:
        raise ValueError("a VLM cache needs the vision tokens (vis=)")
    t = vis.shape[1]
    shape = (lead[0], batch, t, hkv, dh)
    if tp is not None:
        shape = tp.cache_block("layers/cross/k", shape, batch)
    cache["layers"] = {
        "self": kv,
        "cross": {"k": torch.empty(shape, dtype=dt, device=device),
                  "v": torch.empty(shape, dtype=dt, device=device)}}
    cache["vis"] = torch.empty((rows, t, cfg.d_model), dtype=dt,
                               device=device)
    fill_source(params, cache, cfg, vis=vis, tp=tp)
    return cache


def fill_source(params, cache, cfg: ModelConfig, vis, tp=None):
    """Write the VLM's fixed-source leaves in place: ``"vis"`` = vis @
    vis_proj and each cross layer's K/V (plus the QKV bias when
    ``cfg.qkv_bias``), the reference's init_cache arithmetic.  Split
    (``tp``): this rank's rows of ``vis`` (the global batch's or its
    own); the column-split ``vis_proj``'s output gathered whole, as the
    forward does; each cross layer's K/V on this rank's block of
    ``wk``/``wv`` (its KV heads, or every head where K/V are
    replicated), gathered over ``dh`` where the rule splits it."""
    dt = torch_dtype(cfg.dtype)
    d = cfg.d_model
    visp = cache["vis"]
    if tp is not None:
        vis = tp.source_rows(vis, visp.shape[0])
    w = params["vis_proj"]
    out = vis.to(device=visp.device, dtype=dt) @ w
    if w.shape[1] != d:                      # column-split over ``model``
        out = tp.gather(out, -1)
    visp.copy_(out)
    b, t = visp.shape[:2]
    cross = cache["layers"]["cross"]
    for gi, lp in enumerate(params["cross_layers"]):
        a = lp["attn"]
        for key in ("k", "v"):
            w = a["w" + key]
            h, dl = w.shape[1:]
            kv = (visp @ w.reshape(d, h * dl)).reshape(b, t, h, dl)
            if cfg.qkv_bias:
                kv = kv + a["b" + key]
            if dl != cfg.head_dim_:                     # dh split
                kv = tp.gather(kv, 3)
            cross[key][gi].copy_(kv)


def prefill(params, cache, tokens, cfg: ModelConfig, seg_lens=None,
            all_logits=False, tp=None):
    """Split (``tp``): ``tokens`` and ``seg_lens`` are this rank's batch
    rows (the same on every ``model`` rank), the cache this rank's block
    (:func:`init_cache`), and the logits come back whole on every rank."""
    s = tokens.shape[1]
    x = cm.embed(params["embed"], tokens, tp)
    positions = (cache["lengths"][:, None]
                 + torch.arange(s, device=tokens.device)[None, :])
    x, new_cache = _stack_cached(params, x, cfg, positions, cache,
                                 seg_lens=seg_lens, tp=tp)
    x = cm.apply_norm(params["ln_f"], x, cfg)
    out = x if all_logits else cm.last_valid_slice(x, seg_lens)
    return cm.gather_vocab(cm.unembed(params["embed"], out, cfg, tp),
                           tp), new_cache


def decode_step(params, cache, tokens, cfg: ModelConfig, seg_lens=None,
                tp=None):
    return prefill(params, cache, tokens, cfg, seg_lens=seg_lens, tp=tp)


def _embed_leaves(params, cfg: ModelConfig, fs, logits: bool) -> dict:
    """The embedding leaf one use reads (``tok`` for the lookup; for the
    logits ``tok`` when tied, else ``unembed``), gathered under FSDP."""
    key = "tok" if not logits or cfg.tie_embeddings else "unembed"
    return {key: gather(fs, params["embed"][key], "embed", key)}


def _hidden(params, tokens, cfg: ModelConfig, vis, remat: RematPolicy,
            density_mean, tp, fs=None):
    """The final normed hidden states (b, s, d) and the aux loss."""
    s = tokens.shape[1]
    x = cm.embed(_embed_leaves(params, cfg, fs, False), tokens, tp)
    if cfg.cross_attn_every:
        if vis is None:
            raise ValueError("a VLM forward needs the vision tokens (vis=)")
        vis = vis.to(device=x.device, dtype=x.dtype)
        w = gather(fs, params["vis_proj"], "vis_proj")
        if w.shape[1] != cfg.d_model:        # column-split over ``model``
            # Every rank's cross layers read the whole projected tokens.
            vis = tp.gather(tp.copy(vis) @ w, -1)
        else:
            vis = vis @ w
    positions = torch.arange(s, device=tokens.device)[None, :]
    x, aux = _stack_nocache(params, x, cfg, positions, vis, remat,
                            density_mean, tp, fs)
    return cm.apply_norm(gather(fs, params["ln_f"], "ln_f"), x, cfg), aux


def forward(params, tokens, cfg: ModelConfig, vis=None,
            remat: RematPolicy = RematPolicy.SAVE_DOTS, density_mean=None,
            tp=None, fs=None):
    """tokens (b, s) -> (logits (b, s, padded vocab), aux loss);
    ``density_mean``: see ``common._route``.  Under ``tp`` the logits are
    gathered whole on every rank, as the reference's forward returns
    them."""
    x, aux = _hidden(params, tokens, cfg, vis, remat, density_mean, tp, fs)
    logits = cm.unembed(_embed_leaves(params, cfg, fs, True), x, cfg, tp)
    return cm.gather_vocab(logits, tp), aux


def loss_fn(params, batch, cfg: ModelConfig,
            remat: RematPolicy = RematPolicy.SAVE_DOTS, density_mean=None,
            tp=None, fs=None):
    """Mean CE + aux; under ``tp`` the vocab-parallel loss over this
    rank's logit columns (never gathered)."""
    x, aux = _hidden(params, batch["tokens"], cfg, batch.get("vis"), remat,
                     density_mean, tp, fs)
    logits = cm.unembed(_embed_leaves(params, cfg, fs, True), x, cfg, tp)
    ce = cm.cross_entropy(logits, batch["labels"], cfg.vocab, tp)
    return ce + aux, {"ce": ce, "aux": aux}


def build(cfg: ModelConfig, device: torch.device, tp=None,
          fs=None) -> cm.ModelApply:
    """``tp`` (a ``distributed.tensor_parallel.ModelParallel``) binds
    tensor and expert parallel execution into every entry point:
    ``init``, ``forward`` and ``loss``, and the cache entry points on
    this rank's block of the cache (:func:`init_cache`,
    :func:`fill_source`).  ``fs`` (a ``distributed.fsdp.DataShards``)
    binds FSDP into ``init``, ``forward`` and ``loss``; the cache entry
    points then refuse (``common.fsdp_refuses_serving``)."""
    vlm = bool(cfg.cross_attn_every)
    entries = dict(
        config=cfg,
        init=functools.partial(init, cfg=cfg, device=device, tp=tp, fs=fs),
        forward=functools.partial(forward, cfg=cfg, tp=tp, fs=fs),
        loss=functools.partial(loss_fn, cfg=cfg, tp=tp, fs=fs))
    if fs is not None:
        return cm.ModelApply(
            **entries, init_cache=cm.fsdp_refuses_serving,
            prefill=cm.fsdp_refuses_serving,
            decode_step=cm.fsdp_refuses_serving,
            fill_source=cm.fsdp_refuses_serving, data_shards=fs)
    return cm.ModelApply(
        **entries,
        init_cache=functools.partial(init_cache, cfg=cfg, device=device,
                                     tp=tp),
        prefill=functools.partial(prefill, cfg=cfg, tp=tp),
        decode_step=functools.partial(decode_step, cfg=cfg, tp=tp),
        reset_slots=cm.reset_lengths,
        kv_pool=("layers", "self") if vlm else ("layers",),
        fill_source=(functools.partial(fill_source, cfg=cfg, tp=tp)
                     if vlm else None),
    )
