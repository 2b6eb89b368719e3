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

Tensor parallel over a mesh's ``model`` axis (``build(cfg, device, tp)``,
every entry point):

* **Storage follows the rule.**  Each rank holds exactly its
  ``sharding.param_spec`` block of every leaf: a contiguous block of
  ``in_proj``'s concatenated z/x/B/C/dt columns, of the conv channels
  (``conv_w``, ``conv_b``) and of ``d_inner`` (``norm_w``, ``out_proj``'s
  rows), each replicated where it does not divide; ``A_log``, ``D`` and
  ``dt_bias`` whole.  So checkpoints, ZeRO-1 and ``convert.from_jax``
  followed by ``sharding.shard_params`` need nothing of their own.
* **Compute splits by SSM heads** (:func:`apply_mamba` under ``tp``).
  The in_proj block's columns are gathered whole, the conv runs on this
  rank's channels and is gathered whole, and the scan runs on this
  rank's ``ssm_heads / model`` heads (with the B/C groups they read); the gated
  RMSNorm's statistic over the whole ``d_inner`` is this rank's sum of
  squares all-reduced, and ``out_proj``'s row-split partial sums leave
  through a *reduce*.  Where the heads do not divide, every rank scans
  every head and keeps its ``d_inner`` rows; where ``d_inner`` does not
  divide either, every rank runs the whole block after the gathers and
  ``out_proj`` whole.  The picks (split or replicated ``in_proj``, conv
  and ``d_inner``, heads or whole) are ``ModelParallel``'s, read from
  the rule.
* **The cache is the rank's ``sharding.cache_spec`` block**: its batch
  rows, the SSM state of its heads where the heads split (else every
  head), the conv window of its channels where the conv splits (else
  every channel).  The heads rule and the conv's width rule are the
  ones the compute's picks read, so the block a rank scans and
  convolves is the block it holds.  Under ``long_context`` (batch 1)
  the rows are the one row on every ``data`` rank.
"""
from __future__ import annotations

import functools
import types

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

def mamba_init(gen, cfg: ModelConfig, device, place) -> cm.Params:
    """One block's leaves, each handed to ``place`` as it is drawn
    (``models.common.placer``)."""
    d, di = cfg.d_model, cfg.d_inner
    g, ds, h = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
    conv_ch = di + 2 * g * ds
    dt = torch_dtype(cfg.dtype)
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "in_proj": place("in_proj", cm.dense_init(
            gen, (d, 2 * di + 2 * g * ds + h), d, dt, device)),
        "conv_w": place("conv_w", cm.dense_init(
            gen, (cfg.ssm_conv, conv_ch), cfg.ssm_conv, dt, device)),
        "conv_b": place("conv_b", torch.zeros(conv_ch, dtype=dt,
                                              device=device)),
        "dt_bias": torch.zeros(h, **f32),
        "A_log": torch.log(torch.linspace(1.0, 16.0, h, **f32)),
        "D": torch.ones(h, **f32),
        "norm_w": place("norm_w", torch.ones(di, **f32)),
        "out_proj": place("out_proj", cm.dense_init(gen, (di, d), di, dt,
                                                    device)),
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


# The picks of a block that runs on one rank: every leaf whole.
_WHOLE = types.SimpleNamespace(in_proj_split=False, conv_split=False,
                               ssm_rows_split=False, ssm_heads_split=False)


def apply_mamba(p, x, cfg: ModelConfig, state=None, conv_prev=None,
                seg_lens=None, tp=None):
    """x (b, l, d) -> (y, (ssm_state, conv_prev)).

    Ragged blocks gate dt to zero on invalid positions: the SSD update with
    dt == 0 is the identity (decay exp(0) = 1, zero input), so padding and
    parked slots (seg_lens == 0) never touch the SSM state.

    Under ``tp`` (a ``ModelParallel``) the block runs on this rank's
    blocks of the leaves (the module docstring) and y is whole; ``state``
    is this rank's heads where they split and ``conv_prev`` its channels
    where the conv splits (the cache's blocks), and both come back so.
    Where ``d_inner`` splits, everything after ``zall`` is split code
    (this rank's heads, or its ``d_inner`` rows), so each replicated
    tensor or leaf that enters it goes through a *copy* and each rank's
    gradient of it is summed: ``zall``, the gathered conv output, a
    replicated conv, ``A_log``, ``D`` and ``dt_bias``.  ``in_proj``'s
    block takes ``x`` through its own *copy*: its gather's backward hands
    each rank its columns of the whole gradient, so the two copies on
    that path sum different parts.  The norm's statistic is summed by a
    *reduce* whose result goes through a *copy*: every rank's rows read
    it, so its gradient too is the ranks' sum.  Where ``d_inner`` stays
    whole the code after the gathers is replicated and nothing in it is
    copied."""
    b, l, _ = x.shape
    di, g, ds, h = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
    dh = cfg.ssm_headdim
    mp = tp or _WHOLE
    split = mp.ssm_rows_split
    enter = tp.copy if split else (lambda t: t)
    if mp.in_proj_split:
        zall = tp.gather(tp.copy(x) @ p["in_proj"], -1)
    else:
        zall = x @ p["in_proj"]
    z, xbc, dtr = _split_in_proj(enter(zall), cfg)
    if mp.conv_split:
        n = p["conv_w"].shape[1]
        src = xbc if split else tp.copy(xbc)
        xbc, new_conv = _causal_conv(src.narrow(-1, tp.rank * n, n),
                                     p["conv_w"], p["conv_b"], conv_prev,
                                     seg_lens=seg_lens)
        xbc = enter(tp.gather(F.silu(xbc), -1))
    else:
        xbc, new_conv = _causal_conv(xbc, enter(p["conv_w"]),
                                     enter(p["conv_b"]), conv_prev,
                                     seg_lens=seg_lens)
        xbc = F.silu(xbc)
    xs = xbc[..., :di].reshape(b, l, h, dh)
    B = xbc[..., di:di + g * ds].reshape(b, l, g, ds)
    C = xbc[..., di + g * ds:].reshape(b, l, g, ds)
    heads = slice(None)
    if mp.ssm_heads_split:
        hl = h // tp.size
        heads = slice(tp.rank * hl, tp.rank * hl + hl)
        groups = tp.ssm_groups(hl)
        xs, B, C = xs[:, :, heads], B[:, :, groups], C[:, :, groups]
    dt = F.softplus(dtr[..., heads].float() + enter(p["dt_bias"])[heads])
    valid = cm.seg_mask(l, seg_lens)
    if valid is not None:
        dt = dt * valid.to(dt.dtype)[..., None]
    A = -torch.exp(enter(p["A_log"])[heads])
    D = enter(p["D"])[heads]
    if l == 1 and state is not None:
        y1, new_state = ssd_decode_step(xs[:, 0], dt[:, 0], A, B[:, 0],
                                        C[:, 0], D, state)
        y = y1[:, None]
    else:
        y, new_state = _scan(xs, dt, A, B, C, D, cfg, state)
    y = y.reshape(b, l, -1)
    if split:
        rl = p["norm_w"].shape[0]
        if not mp.ssm_heads_split:
            y = y.narrow(-1, tp.rank * rl, rl)
        gated = y.float() * F.silu(z.narrow(-1, tp.rank * rl, rl).float())
        ms = tp.copy(tp.reduce(gated.square().sum(dim=-1,
                                                  keepdim=True))) / di
    else:
        gated = y.float() * F.silu(z.float())
        ms = gated.square().mean(dim=-1, keepdim=True)
    y = (gated * torch.rsqrt(ms + cfg.norm_eps) * p["norm_w"]).to(x.dtype)
    y = y @ p["out_proj"]
    return (tp.reduce(y) if split else y), (new_state, new_conv)


def _scan(xs, dt, A, B, C, D, cfg: ModelConfig, state=None):
    """The SSD scan of a block: the CUDA kernel on the kernel routes, its
    plain version on ``"xla"`` (and on CPU tensors).  The chunk is the
    reference's adaptive one (the plain version's; the kernel keeps its
    own 64-row tile)."""
    chunk = min(max(128, xs.shape[1] // 16), 1024)
    scan = ssd_ops.ssd if cfg.decode_kernel != "xla" else ssd_plain
    return scan(xs, dt, A, B, C, D, chunk=chunk, init_state=state)


def mamba_layer(lp, x, cfg: ModelConfig, cache, i: int, seg_lens=None,
                tp=None):
    """One pre-norm Mamba-2 residual layer over the cache's layer ``i``:
    its SSM state and conv window (this rank's blocks under ``tp``) are
    read, then overwritten in place."""
    y, (st, cv) = apply_mamba(lp["mamba"], cm.apply_norm(lp["ln"], x, cfg),
                              cfg, state=cache["ssm"][i],
                              conv_prev=cache["conv"][i], seg_lens=seg_lens,
                              tp=tp)
    cache["ssm"][i].copy_(st)
    cache["conv"][i].copy_(cv)
    return x + y


# ---------------------------------------------------------------------------
# LM
# ---------------------------------------------------------------------------

def layers_init(gen, cfg: ModelConfig, device, tp=None) -> list:
    """The ``n_layers`` Mamba-2 layers; under ``tp`` each leaf is cut to
    this rank's block as it is drawn."""
    n = cfg.n_layers
    return [{"ln": cm.norm_init(cfg, device),
             "mamba": mamba_init(gen, cfg, device, cm.placer(
                 tp, ("layers", i, "mamba"), (n,)))} for i in range(n)]


def init(gen: torch.Generator, cfg: ModelConfig, device, tp=None):
    """Random parameters from the reference's distributions (not its
    numbers: torch and JAX generators differ).  With ``tp`` (a
    ``ModelParallel``) each rank keeps its block of every leaf, drawn in
    the one-process order, so the blocks are the one-process leaves'."""
    return {
        "embed": cm.embed_init_params(gen, cfg, device,
                                      place=cm.placer(tp, ("embed",))),
        "ln_f": cm.norm_init(cfg, device),
        "layers": layers_init(gen, cfg, device, tp),
    }


def recurrent_buffers(cfg: ModelConfig, batch: int, device,
                      tp=None) -> cm.Params:
    """Zeroed (L, b, h, ds, dh) fp32 SSM state and (L, b, width - 1, ch)
    conv windows in the model dtype, plus the (b,) cursors; under ``tp``
    this rank's ``cache_spec`` blocks of them for a global ``batch``."""
    h, ds, dh = cfg.ssm_heads, cfg.ssm_state, cfg.ssm_headdim
    conv_ch = cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
    L = cfg.n_layers
    ssm = (L, batch, h, ds, dh)
    conv = (L, batch, cfg.ssm_conv - 1, conv_ch)
    rows = batch
    if tp is not None:
        ssm = tp.cache_block("ssm", ssm, batch)
        conv = tp.cache_block("conv", conv, batch)
        rows = tp.cache_rows(batch)
    return {
        "ssm": torch.zeros(ssm, dtype=torch.float32, device=device),
        "conv": torch.zeros(conv, dtype=torch_dtype(cfg.dtype),
                            device=device),
        "lengths": torch.zeros(rows, dtype=torch.int32, device=device),
    }


def init_cache(params, cfg: ModelConfig, batch: int, max_len: int,
               n_pages=None, *, device, tp=None):
    """``max_len`` and ``n_pages`` are accepted for serve-engine API
    uniformity; the decode state is O(1) per slot, so nothing is paged.
    Split (``tp``): this rank's block of the one-process cache for a
    global ``batch`` (the module docstring)."""
    del params, max_len, n_pages
    return recurrent_buffers(cfg, batch, device, tp)


def prefill(params, cache, tokens, cfg: ModelConfig, seg_lens=None,
            all_logits=False, tp=None):
    """Split (``tp``): ``tokens`` and ``seg_lens`` are this rank's batch
    rows, the cache its block (:func:`init_cache`), and the logits come
    back whole on every rank."""
    s = tokens.shape[1]
    x = cm.embed(params["embed"], tokens, tp)
    for i, lp in enumerate(params["layers"]):
        x = mamba_layer(lp, x, cfg, cache, i, seg_lens=seg_lens, tp=tp)
    x = cm.apply_norm(params["ln_f"], x, cfg)
    out = x if all_logits else cm.last_valid_slice(x, seg_lens)
    new_cache = dict(cache)
    new_cache["lengths"] = (
        cache["lengths"] + (s if seg_lens is None else seg_lens)
    ).to(torch.int32)
    return cm.gather_vocab(cm.unembed(params["embed"], out, cfg, tp),
                           tp), new_cache


def decode_step(params, cache, tokens, cfg: ModelConfig, seg_lens=None,
                tp=None):
    return prefill(params, cache, tokens, cfg, seg_lens=seg_lens, tp=tp)


def mamba_block(lp, h, cfg: ModelConfig, tp=None):
    """One pre-norm Mamba-2 residual layer with no cache (training);
    split over ``model`` under ``tp``."""
    return h + apply_mamba(lp["mamba"], cm.apply_norm(lp["ln"], h, cfg),
                           cfg, tp=tp)[0]


def _logits(params, tokens, cfg: ModelConfig, remat: RematPolicy, tp):
    """The logits, this rank's vocab columns under ``tp``."""
    x = cm.embed(params["embed"], tokens, tp)
    body = apply_remat(functools.partial(mamba_block, cfg=cfg, tp=tp), remat)
    for lp in params["layers"]:
        x = body(lp, x)
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
    )
