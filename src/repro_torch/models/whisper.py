"""Whisper-style encoder-decoder backbone (the port of
``repro.models.whisper``, training's ``forward``/``loss`` and the serving
path; arXiv:2212.04356).

The conv audio front end is a stub, as in the reference: the caller gives
frame embeddings (b, enc_seq, d) and ``encode`` adds sinusoidal positions.
Encoder: bidirectional self-attention; decoder: causal self-attention with
learned positions, then cross-attention to the encoder states.  LayerNorm
and GELU, pre-norm, with final norms.

Parameters are the reference's with the stacked ``enc_layers`` and
``dec_layers`` as per-layer lists.  The cache holds the decoder's self KV
(stacked (L, ...), ring or page pool, written in place), the cross K/V
(L, b, enc_seq, hkv, dh), which ``fill_source`` computes once from the
frames (the encoder and each layer's ``wk``/``wv``, no bias, as the
reference's) and every step only reads, and the ragged cursors.
``forward`` encodes the frames and runs the decoder over the whole block
with no cache, cross-attending to the encoder states; the activation
policy wraps each encoder and each decoder layer.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.remat import RematPolicy, apply_remat
from repro_torch.device import torch_dtype
from repro_torch.models import common as cm

MAX_DEC_POS = 65536  # learned decoder position table (covers decode_32k)


def _sinusoid(seq: int, d: int, device) -> torch.Tensor:
    pos = torch.arange(seq, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(d // 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / torch.pow(10000.0, 2 * dim / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _enc_layer_init(gen, cfg: ModelConfig, device, at):
    return {"ln1": cm.norm_init(cfg, device),
            "attn": cm.attn_init(gen, cfg, device, place=at("attn")),
            "ln2": cm.norm_init(cfg, device),
            "mlp": cm.mlp_init(gen, cfg, device, place=at("mlp"))}


def _dec_layer_init(gen, cfg: ModelConfig, device, at):
    return {"ln1": cm.norm_init(cfg, device),
            "self_attn": cm.attn_init(gen, cfg, device,
                                      place=at("self_attn")),
            "ln2": cm.norm_init(cfg, device),
            "cross_attn": cm.attn_init(gen, cfg, device,
                                       place=at("cross_attn")),
            "ln3": cm.norm_init(cfg, device),
            "mlp": cm.mlp_init(gen, cfg, device, place=at("mlp"))}


def init(gen: torch.Generator, cfg: ModelConfig, device, tp=None):
    """Random parameters from the reference's distributions (not its
    numbers: torch and JAX generators differ).  With ``tp`` (a
    ``ModelParallel``) every leaf is drawn whole, in the one-process
    order, and only this rank's block of it is kept (``dec_pos``, norms
    and biases stay whole)."""
    def stack(name, n, layer):
        return [layer(gen, cfg, device,
                      lambda sub, i=i: cm.placer(tp, (name, i, sub), (n,)))
                for i in range(n)]

    return {
        "embed": cm.embed_init_params(gen, cfg, device,
                                      place=cm.placer(tp, ("embed",))),
        "dec_pos": cm.placer(tp, ())("dec_pos", cm.embed_init(
            gen, (MAX_DEC_POS, cfg.d_model), torch_dtype(cfg.dtype),
            device)),
        "enc_layers": stack("enc_layers", cfg.enc_layers, _enc_layer_init),
        "dec_layers": stack("dec_layers", cfg.n_layers, _dec_layer_init),
        "ln_enc": cm.norm_init(cfg, device),
        "ln_f": cm.norm_init(cfg, device),
    }


def _enc_block(lp, x, cfg: ModelConfig, positions, tp=None):
    x = x + cm.apply_attn(lp["attn"], cm.apply_norm(lp["ln1"], x, cfg), cfg,
                          positions, causal=False, use_rope=False, tp=tp)
    return x + cm.apply_mlp(lp["mlp"], cm.apply_norm(lp["ln2"], x, cfg), cfg,
                            tp=tp)


def encode(params, frames: torch.Tensor, cfg: ModelConfig,
           remat: RematPolicy = RematPolicy.SAVE_DOTS,
           tp=None) -> torch.Tensor:
    """frames: stub embeddings (b, s_enc, d) -> encoder states (whole on
    every rank under ``tp``).  ``remat`` wraps each layer when grad mode is
    on (it is a no-op without it)."""
    b, s, d = frames.shape
    dt = torch_dtype(cfg.dtype)
    x = frames.to(dt) + _sinusoid(s, d, frames.device).to(dt)
    positions = torch.arange(s, device=frames.device)[None, :]
    body = apply_remat(functools.partial(_enc_block, cfg=cfg,
                                         positions=positions, tp=tp), remat)
    for lp in params["enc_layers"]:
        x = body(lp, x)
    return cm.apply_norm(params["ln_enc"], x, cfg)


def _dec_block(lp, h, cfg: ModelConfig, positions, self_cache, cross_cache,
               seg_lens=None):
    h = h + cm.apply_attn(lp["self_attn"], cm.apply_norm(lp["ln1"], h, cfg),
                          cfg, positions, self_cache, seg_lens=seg_lens,
                          use_rope=False)
    h = h + cm.apply_attn(lp["cross_attn"], cm.apply_norm(lp["ln2"], h, cfg),
                          cfg, positions, cross_cache, seg_lens=seg_lens,
                          causal=False, use_rope=False)
    return h + cm.apply_mlp(lp["mlp"], cm.apply_norm(lp["ln3"], h, cfg), cfg)


def init_cache(params, cfg: ModelConfig, batch: int, max_len: int,
               n_pages=None, *, device, vis=None, frames=None):
    """Self KV as transformer.init_cache's ((L, ...) ring or pool) and the
    cross K/V (L, batch, enc_seq, hkv, dh) of ``frames`` (``vis`` doubles
    as the frames argument, as in the reference)."""
    frames = frames if frames is not None else vis
    if frames is None:
        raise ValueError("a whisper cache needs the encoder frames "
                         "(frames=)")
    L, hkv, dh = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim_
    dt = torch_dtype(cfg.dtype)
    cache = {}
    if cfg.cache_layout == "paged":
        self_kv, pages = cm.paged_kv_buffers((L,), batch, max_len, cfg,
                                             n_pages, device=device)
    else:
        shape = (L, batch, max_len + 1, hkv, dh)
        self_kv = {"k": torch.zeros(shape, dtype=dt, device=device),
                   "v": torch.zeros(shape, dtype=dt, device=device)}
        pages = None
    shape = (L, batch, frames.shape[1], hkv, dh)
    cache["self"] = self_kv
    cache["cross"] = {"k": torch.empty(shape, dtype=dt, device=device),
                      "v": torch.empty(shape, dtype=dt, device=device)}
    cache["lengths"] = torch.zeros(batch, dtype=torch.int32, device=device)
    if pages is not None:
        cache["pages"] = pages
    fill_source(params, cache, cfg, frames=frames)
    return cache


def fill_source(params, cache, cfg: ModelConfig, vis=None, frames=None):
    """Run the encoder over ``frames`` and write each decoder layer's cross
    K/V (no bias) into the cache's buffers, in place."""
    frames = frames if frames is not None else vis
    cross = cache["cross"]
    enc = encode(params, frames.to(cross["k"].device), cfg)
    b, t, d = enc.shape
    hkv, dh = cfg.n_kv_heads, cfg.head_dim_
    for i, lp in enumerate(params["dec_layers"]):
        for key in ("k", "v"):
            w = lp["cross_attn"]["w" + key].reshape(d, hkv * dh)
            cross[key][i].copy_((enc @ w).reshape(b, t, hkv, dh))


def prefill(params, cache, tokens, cfg: ModelConfig, seg_lens=None,
            all_logits=False):
    s = tokens.shape[1]
    lengths = cache["lengths"]
    pages = cache.get("pages")
    positions = (lengths[:, None]
                 + torch.arange(s, device=tokens.device)[None, :])
    # Per-slot learned position rows, clamped at the table's edge.
    x = cm.embed(params["embed"], tokens) + params["dec_pos"][
        positions.long().clamp(0, MAX_DEC_POS - 1)]
    self_kv, cross = cache["self"], cache["cross"]
    for i, lp in enumerate(params["dec_layers"]):
        sc = {"k": self_kv["k"][i], "v": self_kv["v"][i], "lengths": lengths}
        if pages is not None:
            sc["pages"] = pages
        x = _dec_block(lp, x, cfg, positions, sc,
                       {"k": cross["k"][i], "v": cross["v"][i]},
                       seg_lens=seg_lens)
    x = cm.apply_norm(params["ln_f"], x, cfg)
    out = x if all_logits else cm.last_valid_slice(x, seg_lens)
    new_cache = dict(cache)
    new_cache["lengths"] = (
        lengths + (s if seg_lens is None else seg_lens)).to(torch.int32)
    return cm.unembed(params["embed"], out, cfg), new_cache


def decode_step(params, cache, tokens, cfg: ModelConfig, seg_lens=None):
    return prefill(params, cache, tokens, cfg, seg_lens=seg_lens)


def _train_dec_block(lp, h, enc_out, cfg: ModelConfig, positions, tp=None):
    """A decoder layer with no cache: causal self-attention over the block,
    cross-attention projecting ``enc_out`` through ``wk``/``wv``."""
    h = h + cm.apply_attn(lp["self_attn"], cm.apply_norm(lp["ln1"], h, cfg),
                          cfg, positions, use_rope=False, tp=tp)
    h = h + cm.apply_attn(lp["cross_attn"], cm.apply_norm(lp["ln2"], h, cfg),
                          cfg, positions, kv_src=enc_out, causal=False,
                          use_rope=False, tp=tp)
    return h + cm.apply_mlp(lp["mlp"], cm.apply_norm(lp["ln3"], h, cfg), cfg,
                            tp=tp)


def _logits(params, tokens, cfg: ModelConfig, frames, remat: RematPolicy,
            tp):
    """The logits, this rank's vocab columns under ``tp``."""
    if frames is None:
        raise ValueError("a whisper forward needs the encoder frames "
                         "(frames=)")
    enc_out = encode(params, frames.to(tokens.device), cfg, remat, tp)
    s = tokens.shape[1]
    x = cm.embed(params["embed"], tokens, tp) + params["dec_pos"][None, :s]
    positions = torch.arange(s, device=tokens.device)[None, :]
    body = apply_remat(functools.partial(_train_dec_block, cfg=cfg,
                                         positions=positions, tp=tp), remat)
    for lp in params["dec_layers"]:
        x = body(lp, x, enc_out)
    x = cm.apply_norm(params["ln_f"], x, cfg)
    return cm.unembed(params["embed"], x, cfg, tp)


def forward(params, tokens, cfg: ModelConfig, frames=None,
            remat: RematPolicy = RematPolicy.SAVE_DOTS, tp=None):
    """tokens (b, s), frames (b, s_enc, d) -> (logits, aux = 0).  Under
    ``tp`` the logits are gathered whole on every rank."""
    logits = _logits(params, tokens, cfg, frames, remat, tp)
    return (cm.gather_vocab(logits, tp),
            torch.zeros((), dtype=torch.float32, device=logits.device))


def loss_fn(params, batch, cfg: ModelConfig,
            remat: RematPolicy = RematPolicy.SAVE_DOTS, tp=None):
    """Mean CE; under ``tp`` the vocab-parallel loss over this rank's
    logit columns (never gathered)."""
    logits = _logits(params, batch["tokens"], cfg, batch["frames"], remat,
                     tp)
    ce = cm.cross_entropy(logits, batch["labels"], cfg.vocab, tp)
    aux = torch.zeros((), dtype=torch.float32, device=logits.device)
    return ce + aux, {"ce": ce, "aux": aux}


def build(cfg: ModelConfig, device: torch.device, tp=None) -> cm.ModelApply:
    """``tp`` (a ``distributed.tensor_parallel.ModelParallel``) binds
    tensor parallel execution into ``init``, ``forward`` and ``loss``; the
    cache entry points then refuse."""
    if tp is not None:
        return cm.ModelApply(
            config=cfg,
            init=functools.partial(init, cfg=cfg, device=device, tp=tp),
            forward=functools.partial(forward, cfg=cfg, tp=tp),
            loss=functools.partial(loss_fn, cfg=cfg, tp=tp),
            init_cache=cm.single_rank, prefill=cm.single_rank,
            decode_step=cm.single_rank, fill_source=cm.single_rank)
    return cm.ModelApply(
        config=cfg,
        init=functools.partial(init, cfg=cfg, device=device),
        forward=functools.partial(forward, cfg=cfg),
        loss=functools.partial(loss_fn, cfg=cfg),
        init_cache=functools.partial(init_cache, cfg=cfg, device=device),
        prefill=functools.partial(prefill, cfg=cfg),
        decode_step=functools.partial(decode_step, cfg=cfg),
        reset_slots=cm.reset_lengths,
        kv_pool=("self",),
        fill_source=functools.partial(fill_source, cfg=cfg),
    )
