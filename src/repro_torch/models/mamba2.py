"""Mamba-2 LM (SSD, attention-free), the port of ``repro.models.mamba2``
(arXiv:2405.21060): training's ``forward``/``loss`` and the serving path.

Parameters are the reference's layouts with ``params["layers"]`` a list of
per-layer dicts ``{"ln", "mamba": {in_proj, conv_w, conv_b, dt_bias, A_log,
D, norm_w, out_proj}}``; ``dt_bias``, ``A_log``, ``D`` and ``norm_w`` stay
fp32 whatever the model dtype.  The decode state is O(1) per slot: an
(L, b, h, ds, dh) fp32 SSM state and an (L, b, width - 1, channels) conv
window, each layer's slice overwritten in place by ``prefill``.

Every prefill (a block of more than one token) runs the SSD chunked scan:
through the CUDA kernel on the kernel routes (``decode_kernel != "xla"``,
the rule ``models.common.apply_attn`` follows), its plain version on the
``"xla"`` route and on CPU tensors.  A single-token step with a state runs
``ssd_decode_step`` (plain torch, as in the reference).  ``forward`` runs
every layer over the whole block from a zero state, the reference's
training use of ``ssd_chunked``.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.remat import RematPolicy, apply_remat
from repro_torch.device import torch_dtype
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.kernels.ssd.ssd import ssd_decode_step, ssd_plain
from repro_torch.models import common as cm


# ---------------------------------------------------------------------------
# Mamba-2 block
# ---------------------------------------------------------------------------

def mamba_init(gen, cfg: ModelConfig, device) -> cm.Params:
    d, di = cfg.d_model, cfg.d_inner
    g, ds, h = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
    conv_ch = di + 2 * g * ds
    dt = torch_dtype(cfg.dtype)
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "in_proj": cm.dense_init(gen, (d, 2 * di + 2 * g * ds + h), d, dt,
                                 device),
        "conv_w": cm.dense_init(gen, (cfg.ssm_conv, conv_ch), cfg.ssm_conv,
                                dt, device),
        "conv_b": torch.zeros(conv_ch, dtype=dt, device=device),
        "dt_bias": torch.zeros(h, **f32),
        "A_log": torch.log(torch.linspace(1.0, 16.0, h, **f32)),
        "D": torch.ones(h, **f32),
        "norm_w": torch.ones(di, **f32),
        "out_proj": cm.dense_init(gen, (di, d), di, dt, device),
    }


def _split_in_proj(z_all, cfg: ModelConfig):
    di, g, ds, h = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
    z = z_all[..., :di]
    xbc = z_all[..., di:di + di + 2 * g * ds]
    dt = z_all[..., -h:]
    return z, xbc, dt


def _causal_conv(xbc, w, b, prev=None, seg_lens=None):
    """Depthwise causal conv1d.  xbc (b, l, ch); w (width, ch).

    ``prev`` (b, width-1, ch) continues a streaming sequence; returns
    (out, new_prev).  With ragged ``seg_lens``, each slot's new window ends
    at its own last valid token: ext[b, seg_lens[b] : seg_lens[b]+width-1]
    (the first width-1 entries of ext are ``prev``, so seg_lens == 0 keeps
    the window untouched: a parked slot)."""
    width = w.shape[0]
    bsz, l, ch = xbc.shape
    if prev is None:
        prev = torch.zeros((bsz, width - 1, ch), dtype=xbc.dtype,
                           device=xbc.device)
    ext = torch.cat([prev, xbc], dim=1)                  # (b, l+w-1, ch)
    out = sum(ext[:, i:i + l] * w[i][None, None] for i in range(width)) \
        + b[None, None]
    if width == 1:
        new_prev = prev
    elif seg_lens is None:
        new_prev = ext[:, -(width - 1):]
    else:
        idx = (seg_lens.long()[:, None]
               + torch.arange(width - 1, device=xbc.device)[None, :])
        new_prev = torch.gather(ext, 1, idx[..., None].expand(-1, -1, ch))
    return out, new_prev


def apply_mamba(p, x, cfg: ModelConfig, state=None, conv_prev=None,
                seg_lens=None):
    """x (b, l, d) -> (y, (ssm_state, conv_prev)).

    Ragged blocks gate dt to zero on invalid positions: the SSD update with
    dt == 0 is the identity (decay exp(0) = 1, zero input), so padding and
    parked slots (seg_lens == 0) never touch the SSM state."""
    b, l, _ = x.shape
    di, g, ds, h = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
    dh = cfg.ssm_headdim
    zall = x @ p["in_proj"]
    z, xbc, dtr = _split_in_proj(zall, cfg)
    xbc, new_conv = _causal_conv(xbc, p["conv_w"], p["conv_b"], conv_prev,
                                 seg_lens=seg_lens)
    xbc = F.silu(xbc)
    xs = xbc[..., :di].reshape(b, l, h, dh)
    B = xbc[..., di:di + g * ds].reshape(b, l, g, ds)
    C = xbc[..., di + g * ds:].reshape(b, l, g, ds)
    dt = F.softplus(dtr.float() + p["dt_bias"])
    valid = cm.seg_mask(l, seg_lens)
    if valid is not None:
        dt = dt * valid.to(dt.dtype)[..., None]
    A = -torch.exp(p["A_log"])
    if l == 1 and state is not None:
        y1, new_state = ssd_decode_step(xs[:, 0], dt[:, 0], A, B[:, 0],
                                        C[:, 0], p["D"], state)
        y = y1[:, None]
    else:
        # The reference's adaptive chunk (the plain version's; the kernel
        # keeps its own 64-row tile).
        chunk = min(max(128, l // 16), 1024)
        scan = ssd_ops.ssd if cfg.decode_kernel != "xla" else ssd_plain
        y, new_state = scan(xs, dt, A, B, C, p["D"], chunk=chunk,
                            init_state=state)
    y = y.reshape(b, l, di)
    gated = y.float() * F.silu(z.float())
    ms = gated.square().mean(dim=-1, keepdim=True)
    y = (gated * torch.rsqrt(ms + cfg.norm_eps) * p["norm_w"]).to(x.dtype)
    return y @ p["out_proj"], (new_state, new_conv)


def mamba_layer(lp, x, cfg: ModelConfig, cache, i: int, seg_lens=None):
    """One pre-norm Mamba-2 residual layer over the cache's layer ``i``:
    its SSM state and conv window are read, then overwritten in place."""
    y, (st, cv) = apply_mamba(lp["mamba"], cm.apply_norm(lp["ln"], x, cfg),
                              cfg, state=cache["ssm"][i],
                              conv_prev=cache["conv"][i], seg_lens=seg_lens)
    cache["ssm"][i].copy_(st)
    cache["conv"][i].copy_(cv)
    return x + y


# ---------------------------------------------------------------------------
# LM
# ---------------------------------------------------------------------------

def _layer_init(gen, cfg: ModelConfig, device):
    return {"ln": cm.norm_init(cfg, device),
            "mamba": mamba_init(gen, cfg, device)}


def init(gen: torch.Generator, cfg: ModelConfig, device):
    """Random parameters from the reference's distributions (not its
    numbers: torch and JAX generators differ)."""
    return {
        "embed": cm.embed_init_params(gen, cfg, device),
        "ln_f": cm.norm_init(cfg, device),
        "layers": [_layer_init(gen, cfg, device) for _ in range(cfg.n_layers)],
    }


def recurrent_buffers(cfg: ModelConfig, batch: int, device) -> cm.Params:
    """Zeroed (L, b, h, ds, dh) fp32 SSM state and (L, b, width - 1, ch)
    conv windows in the model dtype."""
    h, ds, dh = cfg.ssm_heads, cfg.ssm_state, cfg.ssm_headdim
    conv_ch = cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
    L = cfg.n_layers
    return {
        "ssm": torch.zeros((L, batch, h, ds, dh), dtype=torch.float32,
                           device=device),
        "conv": torch.zeros((L, batch, cfg.ssm_conv - 1, conv_ch),
                            dtype=torch_dtype(cfg.dtype), device=device),
    }


def init_cache(params, cfg: ModelConfig, batch: int, max_len: int,
               n_pages=None, *, device):
    """``max_len`` and ``n_pages`` are accepted for serve-engine API
    uniformity; the decode state is O(1) per slot, so nothing is paged."""
    del params, max_len, n_pages
    cache = recurrent_buffers(cfg, batch, device)
    cache["lengths"] = torch.zeros(batch, dtype=torch.int32, device=device)
    return cache


def prefill(params, cache, tokens, cfg: ModelConfig, seg_lens=None,
            all_logits=False):
    s = tokens.shape[1]
    x = cm.embed(params["embed"], tokens)
    for i, lp in enumerate(params["layers"]):
        x = mamba_layer(lp, x, cfg, cache, i, seg_lens=seg_lens)
    x = cm.apply_norm(params["ln_f"], x, cfg)
    out = x if all_logits else cm.last_valid_slice(x, seg_lens)
    new_cache = dict(cache)
    new_cache["lengths"] = (
        cache["lengths"] + (s if seg_lens is None else seg_lens)
    ).to(torch.int32)
    return cm.unembed(params["embed"], out, cfg), new_cache


def decode_step(params, cache, tokens, cfg: ModelConfig, seg_lens=None):
    return prefill(params, cache, tokens, cfg, seg_lens=seg_lens)


def mamba_block(lp, h, cfg: ModelConfig):
    """One pre-norm Mamba-2 residual layer with no cache (training)."""
    y, _ = apply_mamba(lp["mamba"], cm.apply_norm(lp["ln"], h, cfg), cfg)
    return h + y


def forward(params, tokens, cfg: ModelConfig,
            remat: RematPolicy = RematPolicy.SAVE_DOTS):
    """tokens (b, s) -> (logits, aux = 0)."""
    x = cm.embed(params["embed"], tokens)
    body = apply_remat(functools.partial(mamba_block, cfg=cfg), remat)
    for lp in params["layers"]:
        x = body(lp, x)
    x = cm.apply_norm(params["ln_f"], x, cfg)
    return (cm.unembed(params["embed"], x, cfg),
            torch.zeros((), dtype=torch.float32, device=x.device))


def loss_fn(params, batch, cfg: ModelConfig,
            remat: RematPolicy = RematPolicy.SAVE_DOTS):
    logits, aux = forward(params, batch["tokens"], cfg, remat=remat)
    ce = cm.cross_entropy(logits, batch["labels"], cfg.vocab)
    return ce + aux, {"ce": ce, "aux": aux}


def build(cfg: ModelConfig, device: torch.device) -> cm.ModelApply:
    return cm.ModelApply(
        config=cfg,
        init=functools.partial(init, cfg=cfg, device=device),
        forward=functools.partial(forward, cfg=cfg),
        loss=functools.partial(loss_fn, cfg=cfg),
        init_cache=functools.partial(init_cache, cfg=cfg, device=device),
        prefill=functools.partial(prefill, cfg=cfg),
        decode_step=functools.partial(decode_step, cfg=cfg),
        reset_slots=cm.reset_recurrent,
    )
