"""Shared model blocks in PyTorch: norms, RoPE, GQA attention over a ragged
KV cache, MLP, MoE, embeddings (the main-path subset of
``repro.models.common``).

Weight layouts are the reference's, so both packages compute the same thing
on the same weights:

    attention:  wq (d, hq, dh)   wk/wv (d, hkv, dh)   wo (hq, dh, d)
    mlp:        wg/wu (d, f)     wd (f, d)
    moe:        router (d, e) fp32   wg/wu (e, d, f)   wd (e, f, d)
    embed:      tok (v, d)       unembed (d, v)

Differences from the reference, all deliberate:

* **In-place caches.**  JAX donates the cache to each jitted call and gets
  a new one back; here ``append_kv`` / ``append_kv_paged`` write the K/V
  buffers in place (``index_put_``) and ``apply_attn`` returns only its
  output.
* **Sink scheme for dropped rows.**  The reference scatters with
  ``mode="drop"``, sending padding, overflow and unmapped-page rows out of
  bounds.  An out-of-range ``index_put_`` is a device-side assert on CUDA,
  and boolean-mask indexing would sync the host every step.  So every KV
  buffer is allocated one unit larger than its public view: the contiguous
  ring as (b, S + 1, ...) with sink position S, the page pool as
  (N + 1, page_size, ...) with sink page N.  Dropped rows are redirected
  to the sink by a static-shape ``torch.where``; nothing ever reads it,
  since readers take the public ``[:, :S]`` / ``[:N]`` views.
* **Cross-attention reads its fixed-source K/V only.**  The reference's
  ``apply_attn`` projects ``kv_src`` through ``wk``/``wv`` and then takes
  the cached K/V in their place (XLA drops the dead work); here a cross
  cache skips those projections.  On the kernel routes the encoder's and
  cross-attention's s > 1 blocks run the flash kernel with
  ``causal=False`` and a cross decode step the dense split-KV decode
  kernel; the reference computes both with ``_sdpa``.
* **No scan, no scan-unroll switch.**  The reference scans stacked layers
  (``cm.scan``, with an unroll flag for the dry run's cost counting); the
  port's layers are Python lists walked by a ``for`` loop, so there is
  nothing to unroll.
* **The loss's chunked logsumexp has its own backward.**  Above
  ``_CE_CHUNK_VOCAB`` the reference scans vocab chunks so the fp32 logits
  never exist whole; autograd through the same loop would save each
  chunk's fp32 exponentials for the backward, which is that tensor after
  all.  :class:`_ChunkedLogSumExp` saves only the logits (in their dtype)
  and the result, and recomputes each chunk's softmax in the backward.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import torch_dtype
from repro_torch.kernels.common import gather_pages

Params = dict[str, Any]


# ---------------------------------------------------------------------------
# Init helpers (the reference's distributions, drawn from a torch.Generator)
# ---------------------------------------------------------------------------

def _normal(gen, shape, device) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=device,
                       dtype=torch.float32)


def dense_init(gen, shape, in_axis_size: int, dtype, device) -> torch.Tensor:
    return (_normal(gen, shape, device) * in_axis_size ** -0.5).to(dtype)


def embed_init(gen, shape, dtype, device) -> torch.Tensor:
    return (_normal(gen, shape, device) * 0.02).to(dtype)


def _keep(key: str, leaf: torch.Tensor) -> torch.Tensor:
    return leaf


# Each init helper hands every leaf, as it is drawn, to ``place(key, leaf)``
# (a tensor-parallel rank keeps its block there; the default keeps it
# whole), so no rank holds a whole split leaf longer than its draw.

def placer(tp, path: tuple, lead: tuple = ()):
    """The init helpers' ``place`` for the leaves under ``path`` (list
    lengths ``lead`` above them): ``tp.place`` under a ``ModelParallel``,
    else keep every leaf whole."""
    return _keep if tp is None else tp.place(path, lead)


def fsdp_refuses_serving(*args, **kwargs):
    """The cache entry points of a model built with FSDP: the gathers run
    in ``forward`` and ``loss`` only, and serving holds its weights whole
    over ``data`` (``sharding.fsdp_needed`` is false for every serve
    cell)."""
    raise NotImplementedError(
        "a model built with fsdp=True trains and runs forward only; its "
        "cache entry points would need the whole weights on every data "
        "rank: build the serving model without fsdp")


def refuse_split_paged(cfg: ModelConfig, tp) -> None:
    """A split model's (``tp``) cache is contiguous: the paged layout (and
    its page table) stays on one rank, as ``ServeEngine`` takes no
    mesh."""
    if tp is not None and cfg.cache_layout == "paged":
        raise NotImplementedError(
            "the paged cache layout runs on one rank (ServeEngine takes "
            "no mesh); a split model takes cache_layout='contiguous'")


def norm_init(cfg: ModelConfig, device, place=_keep) -> Params:
    p = {"w": place("w", torch.ones(cfg.d_model, device=device))}
    if cfg.norm_kind == "layer":
        p["b"] = place("b", torch.zeros(cfg.d_model, device=device))
    return p


def attn_init(gen, cfg: ModelConfig, device, place=_keep) -> Params:
    d = cfg.d_model
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    dt = torch_dtype(cfg.dtype)
    p = {
        "wq": place("wq", dense_init(gen, (d, hq, dh), d, dt, device)),
        "wk": place("wk", dense_init(gen, (d, hkv, dh), d, dt, device)),
        "wv": place("wv", dense_init(gen, (d, hkv, dh), d, dt, device)),
        "wo": place("wo", dense_init(gen, (hq, dh, d), hq * dh, dt, device)),
    }
    if cfg.qkv_bias:
        p["bq"] = place("bq", torch.zeros((hq, dh), dtype=dt, device=device))
        p["bk"] = place("bk", torch.zeros((hkv, dh), dtype=dt, device=device))
        p["bv"] = place("bv", torch.zeros((hkv, dh), dtype=dt, device=device))
    return p


def mlp_init(gen, cfg: ModelConfig, device, place=_keep) -> Params:
    d, f = cfg.d_model, cfg.d_ff
    dt = torch_dtype(cfg.dtype)
    if cfg.act == "swiglu":
        return {
            "wg": place("wg", dense_init(gen, (d, f), d, dt, device)),
            "wu": place("wu", dense_init(gen, (d, f), d, dt, device)),
            "wd": place("wd", dense_init(gen, (f, d), f, dt, device)),
        }
    return {
        "wu": place("wu", dense_init(gen, (d, f), d, dt, device)),
        "wd": place("wd", dense_init(gen, (f, d), f, dt, device)),
    }


def moe_init(gen, cfg: ModelConfig, device, place=_keep) -> Params:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    dt = torch_dtype(cfg.dtype)
    return {
        "router": place("router", dense_init(gen, (d, e), d, torch.float32,
                                             device)),
        "wg": place("wg", dense_init(gen, (e, d, f), d, dt, device)),
        "wu": place("wu", dense_init(gen, (e, d, f), d, dt, device)),
        "wd": place("wd", dense_init(gen, (e, f, d), f, dt, device)),
    }


def embed_init_params(gen, cfg: ModelConfig, device, place=_keep) -> Params:
    v, d = cfg.padded_vocab, cfg.d_model
    dt = torch_dtype(cfg.dtype)
    p = {"tok": place("tok", embed_init(gen, (v, d), dt, device))}
    if not cfg.tie_embeddings:
        p["unembed"] = place("unembed", dense_init(gen, (d, v), d, dt, device))
    return p


# ---------------------------------------------------------------------------
# Norms, RoPE
# ---------------------------------------------------------------------------

def apply_norm(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """RMS or LayerNorm in fp32, output in ``x.dtype``.  The kernel routes
    (``decode_kernel != "xla"``) go through the fused-norm kernel (its
    plain version on CPU tensors); ``"xla"`` stays plain torch."""
    if cfg.decode_kernel != "xla":
        from repro_torch.kernels.fused_norm import ops as norm_ops

        return norm_ops.fused_norm(x, p["w"], p.get("b"), eps=cfg.norm_eps,
                                   kind=cfg.norm_kind)
    h = x.float()
    if cfg.norm_kind == "layer":
        mu = h.mean(dim=-1, keepdim=True)
        var = (h - mu).square().mean(dim=-1, keepdim=True)
        y = (h - mu) * torch.rsqrt(var + cfg.norm_eps) * p["w"] + p["b"]
    else:
        ms = h.square().mean(dim=-1, keepdim=True)
        y = h * torch.rsqrt(ms + cfg.norm_eps) * p["w"]
    return y.to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Half-split rotary in fp32.  x: (b, s, h, dh); positions (b, s) or (s,)."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32,
                                    device=x.device) / half)
    if positions.dim() == 1:
        positions = positions[None, :]
    ang = positions[..., None].float() * freqs                 # (b, s, half)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

# Above this many score elements per (batch, head), or this many KV
# positions, attention switches to the blocked online-softmax path.
_SDPA_CHUNK_THRESHOLD = 4096 * 2048
_SDPA_DECODE_T = 8192


def _offset_rows(q_offset, device) -> torch.Tensor:
    """A query-position offset as a (B,) vector, B in {1, b}."""
    off = torch.as_tensor(q_offset, device=device)
    return off[None] if off.dim() == 0 else off


def _sdpa_naive(q, k, v, causal: bool, q_offset, kv_len=None):
    """q: (b, s, hq, dh); k/v: (b, t, hkv, dh).  fp32 softmax."""
    b, s, hq, dh = q.shape
    t, hkv = k.shape[1], k.shape[2]
    group = hq // hkv
    dev = q.device
    qf = (q.float() * dh ** -0.5).reshape(b, s, hkv, group, dh)
    logits = torch.einsum("bshgd,bthd->bhgst", qf, k.float())
    ki = torch.arange(t, device=dev)
    mask = None
    if causal:
        off = _offset_rows(q_offset, dev)
        qi = off[:, None, None] + torch.arange(s, device=dev)[None, :, None]
        mask = ki[None, None, :] <= qi                          # (B, s, t)
    if kv_len is not None:
        valid = (ki[None, :] < kv_len[:, None])[:, None, :]     # (b, 1, t)
        mask = valid if mask is None else mask & valid
    if mask is not None:
        logits.masked_fill_(~mask[:, None, None], -1e30)
    probs = torch.softmax(logits, dim=-1)
    del logits
    out = torch.einsum("bhgst,bthd->bshgd", probs, v.float())
    return out.reshape(b, s, hq, dh).to(q.dtype)


def _chunk_sizes(s: int, t: int) -> tuple[int, int]:
    """Block shapes bounding the live logits buffer and the trip count."""
    qb = min(s, max(1024, -(-s // 8)))
    ck = min(t, max(1024, -(-t // 8)))
    return qb, ck


def _sdpa_chunked(q, k, v, causal: bool, q_offset, kv_len=None,
                  chunk: int | None = None, q_block: int | None = None):
    """Blocked online-softmax attention: outer loop over q blocks, inner
    loop over KV chunks (the reference's two nested scans)."""
    b, s, hq, dh = q.shape
    t, hkv = k.shape[1], k.shape[2]
    group = hq // hkv
    dev = q.device
    qb, ck = _chunk_sizes(s, t)
    if chunk is not None:
        ck = chunk
    if q_block is not None:
        qb = min(q_block, s)
    qpad, tpad = (-s) % qb, (-t) % ck
    pad = torch.nn.functional.pad
    if qpad:
        q = pad(q, (0, 0, 0, 0, 0, qpad))
    if tpad:
        k = pad(k, (0, 0, 0, 0, 0, tpad))
        v = pad(v, (0, 0, 0, 0, 0, tpad))
    nq, nc = (s + qpad) // qb, (t + tpad) // ck
    qf = (q.float() * dh ** -0.5).reshape(b, nq, qb, hkv, group, dh)
    kc = k.float().reshape(b, nc, ck, hkv, dh)
    vc = v.float().reshape(b, nc, ck, hkv, dh)
    valid = (kv_len if kv_len is not None
             else torch.full((b,), t, device=dev))
    off = _offset_rows(q_offset, dev)
    outs = []
    for iq in range(nq):
        qblk = qf[:, iq]                                  # (b, qb, hkv, g, dh)
        qi = (iq * qb + torch.arange(qb, device=dev)[None, :, None]
              + off[:, None, None])
        m = torch.full((b, hkv, group, qb), -1e30, device=dev)
        l = torch.zeros((b, hkv, group, qb), device=dev)
        acc = torch.zeros((b, hkv, group, qb, dh), device=dev)
        for j in range(nc):
            ki = j * ck + torch.arange(ck, device=dev)[None, :]   # (1, ck)
            logits = torch.einsum("bshgd,bthd->bhgst", qblk, kc[:, j])
            mask = ki[None] < valid[:, None, None]               # (b, 1, ck)
            if causal:
                mask = mask & (ki[None] <= qi)                   # (b, qb, ck)
            logits = torch.where(mask[:, None, None], logits, -1e30)
            m_cur = torch.maximum(m, logits.amax(dim=-1))
            alpha = torch.exp(m - m_cur)
            p = torch.exp(logits - m_cur[..., None])
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bhgst,bthd->bhgsd", p, vc[:, j])
            m = m_cur
        outs.append(acc / l.clamp_min(1e-30)[..., None])     # (b,hkv,g,qb,dh)
    out = torch.stack(outs, dim=1)                           # (b,nq,hkv,g,qb,dh)
    out = out.reshape(b, nq, hq, qb, dh).transpose(2, 3)
    return out.reshape(b, nq * qb, hq, dh)[:, :s].to(q.dtype)


def _sdpa(q, k, v, causal: bool, q_offset, kv_len=None):
    s, t = q.shape[1], k.shape[1]
    if s * t > _SDPA_CHUNK_THRESHOLD or t > _SDPA_DECODE_T:
        return _sdpa_chunked(q, k, v, causal, q_offset, kv_len)
    return _sdpa_naive(q, k, v, causal, q_offset, kv_len)


def seg_mask(s: int, seg_lens: torch.Tensor | None) -> torch.Tensor | None:
    """(b, s) validity mask for a ragged block: col i valid iff i < seg_lens[b]."""
    if seg_lens is None:
        return None
    return torch.arange(s, device=seg_lens.device)[None, :] < seg_lens[:, None]


def last_valid_slice(x: torch.Tensor, seg_lens: torch.Tensor | None
                     ) -> torch.Tensor:
    """Each slot's last valid position: x (b, s, d) -> (b, 1, d).  Slots with
    seg_lens == 0 return row 0 (garbage by contract)."""
    if seg_lens is None:
        return x[:, -1:]
    idx = (seg_lens.long() - 1).clamp(0, x.shape[1] - 1)
    return torch.gather(x, 1, idx[:, None, None].expand(-1, 1, x.shape[2]))


def append_kv(cache_kv: torch.Tensor, new: torch.Tensor, lengths: torch.Tensor,
              seg_lens: torch.Tensor | None, start: int = 0) -> None:
    """Scatter a (b, s, ...) block into a (b, S + 1, ...) ring, in place.

    Row i of slot b lands at position lengths[b] + i.  Invalid rows
    (i >= seg_lens[b]) and overflow (pos >= S) go to the sink position S
    (see the module docstring), never into the public [:, :S] view.  A
    ring that holds the sequence block ``[start, start + S)`` (a rank of
    the split cache) takes the rows whose positions fall inside it; the
    others go to its sink."""
    b, s = new.shape[:2]
    S = cache_kv.shape[1] - 1
    dev = cache_kv.device
    pos = lengths.long()[:, None] + torch.arange(s, device=dev)[None, :]
    if start:
        pos = pos - start
    drop = (pos >= S) | (pos < 0) if start else pos >= S
    valid = seg_mask(s, seg_lens)
    if valid is not None:
        drop = drop | ~valid
    pos = torch.where(drop, S, pos)
    rows = torch.arange(b, device=dev)[:, None].expand(b, s)
    cache_kv.index_put_((rows, pos), new.to(cache_kv.dtype))


# ---------------------------------------------------------------------------
# Paged KV layout: K/V in an (N, page_size, hkv, dh) pool shared across
# slots, addressed through a per-slot (b, pages_per_slot) page table
# (-1 = unmapped).  Buffers carry one extra sink page N past the pool.
# ---------------------------------------------------------------------------

def paged_kv_spec(batch: int, max_len: int, page_size: int,
                  n_pages: int | None = None) -> tuple[int, int]:
    """(pages_per_slot, n_pages); ``n_pages`` None is full capacity."""
    per_slot = -(-max_len // page_size)
    return per_slot, (batch * per_slot if n_pages is None else n_pages)


def paged_kv_buffers(lead: tuple, batch: int, max_len: int, cfg,
                     n_pages: int | None = None, device=None):
    """Zeroed paged K/V buffers (``lead`` stack axes, N + 1 pages: the last
    is the sink) plus the all-unmapped (batch, pages_per_slot) table."""
    per_slot, N = paged_kv_spec(batch, max_len, cfg.kv_page_size, n_pages)
    shape = (*lead, N + 1, cfg.kv_page_size, cfg.n_kv_heads, cfg.head_dim_)
    dt = torch_dtype(cfg.dtype)
    kv = {"k": torch.zeros(shape, dtype=dt, device=device),
          "v": torch.zeros(shape, dtype=dt, device=device)}
    return kv, torch.full((batch, per_slot), -1, dtype=torch.int32,
                          device=device)


def append_kv_paged(pool: torch.Tensor, new: torch.Tensor,
                    lengths: torch.Tensor, seg_lens: torch.Tensor | None,
                    pages: torch.Tensor) -> None:
    """Scatter a (b, s, ...) block into an (N + 1, page_size, ...) buffer,
    in place.

    Row i of slot b lands at logical position lengths[b] + i, i.e. physical
    page pages[b, pos // page_size], offset pos % page_size.  Invalid rows,
    positions past the mapped range and unmapped (-1) pages go to the sink
    page N, never into the public [:N] pool."""
    b, s = new.shape[:2]
    N, psz = pool.shape[0] - 1, pool.shape[1]
    P = pages.shape[1]
    dev = pool.device
    pos = lengths.long()[:, None] + torch.arange(s, device=dev)[None, :]
    pi, wi = pos // psz, pos % psz
    phys = torch.gather(pages.long(), 1, pi.clamp(0, P - 1))
    drop = (pi >= P) | (phys < 0)
    valid = seg_mask(s, seg_lens)
    if valid is not None:
        drop = drop | ~valid
    phys = torch.where(drop, N, phys)
    pool.index_put_(
        (phys.reshape(-1), wi.reshape(-1)),
        new.reshape((b * s,) + tuple(new.shape[2:])).to(pool.dtype),
    )


def _decode_step_kernel(q, kc, vc, kv_len, cfg, pages):
    """Route the s == 1 decode step through the split-KV CUDA kernels.

    A single causal query sits at its slot's cursor, so the causal mask is
    the length mask.  ``pallas_paged`` on a paged cache reads the pool in
    place through the page table; ``pallas_gather`` runs the same kernel
    over the gathered dense view with the KV block pinned to the page size
    (the bitwise reference of the paged path); a contiguous cache runs the
    dense kernel over the ring by strides (no transpose copy)."""
    from repro_torch.kernels.decode_attention import ops as dec_ops

    q1 = q[:, 0]                                       # (b, hq, dh)
    # The count ServeEngine baked from its decode plan, or a pinned one; 0
    # (a direct model user) leaves it to plan_splits' default target.
    splits = cfg.decode_splits or None
    if pages is not None:
        psz, n_pages = kc.shape[1], pages.shape[1]
        if splits:
            splits = min(splits, n_pages)      # at most one split per page
        if cfg.decode_kernel == "pallas_paged":
            out = dec_ops.paged_decode_attention(
                q1, kc, vc, pages, kv_len, splits=splits
            )
        else:
            kd = gather_pages(kc, pages).transpose(1, 2)
            vd = gather_pages(vc, pages).transpose(1, 2)
            out = dec_ops.decode_attention(
                q1, kd, vd, kv_len, bkv=psz, splits=splits
            )
    else:
        out = dec_ops.decode_attention(
            q1, kc.transpose(1, 2), vc.transpose(1, 2), kv_len,
            bkv=min(512, kc.shape[1]), splits=splits,
        )
    return out[:, None]                                # (b, 1, hq, dh)


def _prefill_kernel(q, kc, vc, lengths, kv_len, seg_lens, cfg, pages):
    """Route an s > 1 block (prefill) through the flash-attention kernel.

    Query row i of slot b sits at ``lengths[b] + i`` and sees keys below
    ``kv_len[b]``; rows at or past ``seg_lens[b]`` are padding (a parked
    slot has 0) and come out as zeros.  ``pallas_paged`` reads the pool in
    place through the page table; ``pallas_gather`` runs the same kernel
    over the gathered dense view (the bitwise reference of the paged
    path); a contiguous cache is read from the ring by strides."""
    from repro_torch.kernels.flash_attention import ops as fa_ops

    qh = q.transpose(1, 2)                             # (b, hq, s, dh) view
    kw = dict(causal=True, q_offset=lengths, kv_len=kv_len, q_len=seg_lens)
    if pages is not None and cfg.decode_kernel == "pallas_paged":
        out = fa_ops.paged_flash_attention(qh, kc, vc, pages, **kw)
    else:
        if pages is not None:
            kc, vc = gather_pages(kc, pages), gather_pages(vc, pages)
        out = fa_ops.flash_attention(qh, kc.transpose(1, 2),
                                     vc.transpose(1, 2), **kw)
    return out.transpose(1, 2)                         # (b, s, hq, dh)


def _cross_decode_kernel(q, kc, vc):
    """The s == 1 step of cross-attention over fixed-source K/V
    (b, t, hkv, dh): the dense split-KV decode kernel over the whole
    source, read by strides.  Its split count is planned over the source
    length, never the engine's baked ``decode_splits``, which belongs to
    the self-attention pool."""
    from repro_torch.kernels.decode_attention import ops as dec_ops

    b, t = kc.shape[:2]
    bkv = min(512, t)
    kv_len = torch.full((b,), t, dtype=torch.int32, device=q.device)
    out = dec_ops.decode_attention(
        q[:, 0], kc.transpose(1, 2), vc.transpose(1, 2), kv_len, bkv=bkv,
        splits=dec_ops.plan_splits(t, bkv))
    return out[:, None]                                # (b, 1, hq, dh)


def _source_attention(q, k, v, cfg, causal: bool, seg_lens):
    """Attention with no self-KV cache: the encoder's bidirectional
    layers and cross-attention over a fixed source (b, t, hkv, dh).  On
    the kernel routes an s > 1 block runs the flash kernel (query rows past
    ``seg_lens`` come out as zeros), a cross s == 1 step the dense decode
    kernel; ``"xla"`` stays plain."""
    s = q.shape[1]
    if cfg.decode_kernel == "xla":
        return _sdpa(q, k, v, causal=causal, q_offset=0)
    if s == 1 and not causal:
        return _cross_decode_kernel(q, k, v)
    from repro_torch.kernels.flash_attention import ops as fa_ops

    out = fa_ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                 v.transpose(1, 2), causal=causal,
                                 q_len=seg_lens)
    return out.transpose(1, 2)


def apply_attn(
    p: Params,
    x: torch.Tensor,                  # (b, s, d)
    cfg: ModelConfig,
    positions: torch.Tensor,          # (b, s)
    cache: Params | None = None,      # self: {"k","v" (with sink), "lengths",
                                      # ["pages"]}; cross: {"k","v"}
    seg_lens: torch.Tensor | None = None,  # (b,) valid new tokens per slot
    *,
    kv_src: torch.Tensor | None = None,    # cross-attention source (b, t, d)
    causal: bool = True,
    use_rope: bool = True,
    tp=None,                               # distributed.tensor_parallel
) -> torch.Tensor:
    """GQA attention, returning the (b, s, d) output.

    * A self cache (it has ``"lengths"``): causal attention over the
      ragged cache, this block's K/V appended to its buffers in place.
    * A cross cache (no ``"lengths"``): the fixed-source K/V it holds,
      nothing appended.  The K/V projections of ``kv_src`` are not
      computed (the reference computes and discards them).
    * No cache: attention over ``x`` (or ``kv_src``), bidirectional when
      ``causal`` is False (the encoder).

    RoPE applies to self-attention only (``use_rope`` and no ``kv_src``);
    cross-attention is never causal.  ``tp`` (a ``ModelParallel``): this
    rank's block of the weights, see :func:`_attn_split`; with a self
    cache this rank's block of it, see :func:`_attn_split_cached`, with a
    cross cache this rank's, see :func:`_attn_split_cross`."""
    if tp is not None:
        if cache is None:
            return _attn_split(p, x, cfg, positions, seg_lens, tp, kv_src,
                               causal, use_rope)
        if "lengths" not in cache:
            return _attn_split_cross(p, x, cfg, cache, seg_lens, tp)
        return _attn_split_cached(p, x, cfg, positions, cache, seg_lens, tp,
                                  use_rope and kv_src is None)
    b, s, d = x.shape
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    cross_cached = cache is not None and "lengths" not in cache
    q = (x @ p["wq"].reshape(d, hq * dh)).reshape(b, s, hq, dh)
    if cfg.qkv_bias:
        q = q + p["bq"]
    rotate = use_rope and kv_src is None
    if rotate:
        q = rope(q, positions, cfg.rope_theta)
    if cross_cached:
        out = _source_attention(q, cache["k"], cache["v"], cfg, False,
                                seg_lens)
        return out.reshape(b, s, hq * dh) @ p["wo"].reshape(hq * dh, d)
    src = x if kv_src is None else kv_src
    t = src.shape[1]
    k = (src @ p["wk"].reshape(d, hkv * dh)).reshape(b, t, hkv, dh)
    v = (src @ p["wv"].reshape(d, hkv * dh)).reshape(b, t, hkv, dh)
    if cfg.qkv_bias:
        k = k + p["bk"]
        v = v + p["bv"]
    if rotate:
        k = rope(k, positions, cfg.rope_theta)
    if cache is None:
        out = _source_attention(q, k, v, cfg, causal and kv_src is None,
                                seg_lens)
        return out.reshape(b, s, hq * dh) @ p["wo"].reshape(hq * dh, d)

    lengths = cache["lengths"]
    pages = cache.get("pages")
    if pages is not None:
        append_kv_paged(cache["k"], k, lengths, seg_lens, pages)
        append_kv_paged(cache["v"], v, lengths, seg_lens, pages)
        kc, vc = cache["k"][:-1], cache["v"][:-1]          # public pool view
    else:
        append_kv(cache["k"], k, lengths, seg_lens)
        append_kv(cache["v"], v, lengths, seg_lens)
        kc, vc = cache["k"][:, :-1], cache["v"][:, :-1]    # public ring view
    kv_len = lengths + (s if seg_lens is None else seg_lens)
    if cfg.decode_kernel != "xla" and s == 1:
        out = _decode_step_kernel(q, kc, vc, kv_len, cfg, pages)
    elif cfg.decode_kernel != "xla":
        out = _prefill_kernel(q, kc, vc, lengths, kv_len, seg_lens, cfg,
                              pages)
    else:
        if pages is not None:
            kc, vc = gather_pages(kc, pages), gather_pages(vc, pages)
        out = _sdpa(q, kc, vc, causal=True, q_offset=lengths, kv_len=kv_len)
    return out.reshape(b, s, hq * dh) @ p["wo"].reshape(hq * dh, d)


def _attn_split(p: Params, x, cfg: ModelConfig, positions, seg_lens, tp,
                kv_src=None, causal: bool = True, use_rope: bool = True):
    """Attention with no cache on this rank's block of the weights (their
    shapes say which split the rule chose, ``sharding._attn_dims``); q
    projects ``x``, k and v project ``kv_src`` (a cross-attention source
    (b, t, d), whole on every rank) or ``x``:

    * heads: q, k, v and ``wo`` on this rank's heads.  Where K/V are
      replicated (``n_kv_heads`` does not divide over ``model``), this
      rank projects only the KV heads its query heads read (global query
      head j reads KV head ``j // (hq // hkv)``, ``ModelParallel.kv_heads``)
      from the replicated ``wk``/``wv``, entered through a *copy* so each
      weight's gradient is the sum of the ranks' parts;
    * ``dh``: each projection gives this rank's slice of every head's
      ``dh``.  RoPE pairs ``i`` with ``i + dh/2`` and the scores contract
      over the whole ``dh``, so q, k and v are gathered over ``dh`` before
      RoPE, every rank attends over all heads, and this rank's ``dh``
      slice of the output goes into its rows of ``wo``;
    * replicated: the one-process attention, no collective.

    ``x`` and ``kv_src`` each enter the split region through a *copy*, so
    each one's gradient is the sum of the ranks' parts; RoPE applies where
    the one-process path applies it (``use_rope`` and no ``kv_src``).  The
    split cases end in a *reduce* of ``wo``'s partial sums."""
    b, s, d = x.shape
    hq, dh = cfg.n_heads, cfg.head_dim_
    wq = p["wq"]
    if tuple(wq.shape[1:]) == (hq, dh):                 # replicated
        return apply_attn(p, x, cfg, positions, seg_lens=seg_lens,
                          kv_src=kv_src, causal=causal, use_rope=use_rope)
    x = tp.copy(x)
    src = x if kv_src is None else tp.copy(kv_src)

    def proj(inp, w, bias):
        h, dl = w.shape[1:]
        y = (inp @ w.reshape(d, h * dl)).reshape(*inp.shape[:2], h, dl)
        return y if bias is None else y + bias

    bias = {k: p.get("b" + k) for k in ("q", "k", "v")}
    q = proj(x, wq, bias["q"])
    if wq.shape[1] != hq:                               # heads
        wk, wv = p["wk"], p["wv"]
        if wk.shape[1] == cfg.n_kv_heads:               # replicated K/V
            heads = tp.kv_heads(wq.shape[1])
            wk, wv = tp.copy(wk)[:, heads], tp.copy(wv)[:, heads]
            for key in ("k", "v"):
                if bias[key] is not None:
                    bias[key] = tp.copy(bias[key])[heads]
        k, v = proj(src, wk, bias["k"]), proj(src, wv, bias["v"])
    else:                                               # dh
        k, v = proj(src, p["wk"], bias["k"]), proj(src, p["wv"], bias["v"])
        q, k, v = (tp.gather(t, -1) for t in (q, k, v))
    if use_rope and kv_src is None:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    out = _source_attention(q, k, v, cfg, causal and kv_src is None,
                            seg_lens)
    wo = p["wo"]
    if wq.shape[1] == hq:                               # dh: this rank's slice
        dl = wo.shape[1]
        out = tp.copy(out).narrow(-1, tp.rank * dl, dl)
    hl, dl = wo.shape[:2]
    return tp.reduce(out.reshape(b, s, hl * dl) @ wo.reshape(hl * dl, d))


def _sdpa_partials(q, k, v, q_offset, kv_len):
    """Causal attention of q (b, s, hq, dh) over one block of keys k/v
    (b, t, hkv, dh), unnormalised -> (acc (b, s, hq, dh), m (b, s, hq),
    l (b, s, hq)), fp32: the blocked online softmax of
    :func:`_sdpa_chunked` without its last division.  Key j of the block
    is visible to query row i of slot b iff ``j < kv_len[b]`` and
    ``j <= q_offset[b] + i`` (block coordinates; either may be negative).
    A row that sees no key has m = -1e30, l = 0 and acc = 0, so it drops
    out of the log-sum-exp merge (``distributed.sp_decode``)."""
    b, s, hq, dh = q.shape
    t, hkv = k.shape[1], k.shape[2]
    group = hq // hkv
    dev = q.device
    qb, ck = _chunk_sizes(s, t)
    off = _offset_rows(q_offset, dev)
    outs = []
    for q0 in range(0, s, qb):
        qblk = (q[:, q0:q0 + qb].float() * dh ** -0.5)
        n = qblk.shape[1]
        qblk = qblk.reshape(b, n, hkv, group, dh)
        qi = (off[:, None, None] + q0
              + torch.arange(n, device=dev)[None, :, None])       # (B, n, 1)
        m = torch.full((b, hkv, group, n), -1e30, device=dev)
        l = torch.zeros((b, hkv, group, n), device=dev)
        acc = torch.zeros((b, hkv, group, n, dh), device=dev)
        for k0 in range(0, t, ck):
            kc, vc = k[:, k0:k0 + ck].float(), v[:, k0:k0 + ck].float()
            ki = k0 + torch.arange(kc.shape[1], device=dev)[None, None, :]
            mask = ((ki < kv_len[:, None, None]) & (ki <= qi))[:, None, None]
            logits = torch.einsum("bshgd,bthd->bhgst", qblk, kc)
            logits = torch.where(mask, logits, -1e30)
            m_cur = torch.maximum(m, logits.amax(dim=-1))
            alpha = torch.exp(m - m_cur)
            p = torch.where(mask, torch.exp(logits - m_cur[..., None]), 0.0)
            del logits
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bhgst,bthd->bhgsd", p, vc)
            m = m_cur
        outs.append((acc.permute(0, 3, 1, 2, 4).reshape(b, n, hq, dh),
                     m.permute(0, 3, 1, 2).reshape(b, n, hq),
                     l.permute(0, 3, 1, 2).reshape(b, n, hq)))
    return tuple(torch.cat(parts, dim=1) for parts in zip(*outs))


def _attn_split_cached(p: Params, x, cfg: ModelConfig, positions, cache,
                       seg_lens, tp, use_rope: bool = True):
    """Self-attention over a split cache on this rank's block of the
    weights.  The cache ring holds this rank's block ``[start, start +
    S_l)`` of the sequence (``start = tp.seq_rank * S_l``) for this rank's
    batch rows (``sharding.cache_spec``), in one of two schedules:

    * sequence over ``model`` (every KV head in the ring): q, k and v are
      projected on this rank's block of the weights and gathered over
      ``model`` to every head (and the whole ``dh``, where the rule
      splits ``dh``; replicated K/V weights give every KV head already),
      and every query head attends over the block;
    * ``long_context``, sequence over ``data``: where heads split over
      ``model`` each rank keeps its own, with no gather: its query heads
      over its KV heads in the ring (the ring holds this rank's KV heads
      where they split; where the K/V weights are replicated it holds
      every KV head and the query heads read theirs,
      ``ModelParallel.kv_heads``).  A ``dh`` split gathers as above.

    q and k are rotated where ``use_rope`` (whisper's decoder is not).
    Each new K/V row is written by the rank whose block holds its
    position and goes to the sink on every other rank (:func:`append_kv`
    with ``start``), with no host sync.  The partials of the block (the
    causal offsets moved into block coordinates) merge by the
    log-sum-exp all-reduce over the sequence's group
    (``distributed.sp_decode.merge_partials``: the schedule of
    ``sp_decode``).  On a kernel route a decode step's partials come from
    the dense split-KV decode kernel on the block
    (``sp_decode.local_partials``).  The rank's heads (or ``dh`` slice)
    of the merged output go into its rows of ``wo``, whose partial sums
    leave through a *reduce*."""
    from repro_torch.distributed import sp_decode

    b, s, d = x.shape
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    keep = tp.long_context and p["wq"].shape[1] != hq    # local heads

    def proj(w, bias, heads):
        h, dl = w.shape[1:]
        y = (x @ w.reshape(d, h * dl)).reshape(b, s, h, dl)
        if bias is not None:
            y = y + bias
        if h != heads and not keep:                     # heads split
            y = tp.gather(y, 2)
        elif dl != dh:                                  # dh split
            y = tp.gather(y, 3)
        return y

    q = proj(p["wq"], p.get("bq"), hq)
    k = proj(p["wk"], p.get("bk"), hkv)
    v = proj(p["wv"], p.get("bv"), hkv)
    if use_rope:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    lengths = cache["lengths"]
    s_l = cache["k"].shape[1] - 1
    start = tp.seq_rank * s_l
    append_kv(cache["k"], k, lengths, seg_lens, start)
    append_kv(cache["v"], v, lengths, seg_lens, start)
    kc, vc = cache["k"][:, :-1], cache["v"][:, :-1]    # public ring view
    if keep and kc.shape[2] == hkv:                    # replicated K/V
        heads = tp.kv_heads(q.shape[2])
        kc, vc = kc[:, :, heads], vc[:, :, heads]
    kv_len = lengths + (s if seg_lens is None else seg_lens)
    if cfg.decode_kernel != "xla" and s == 1:
        acc, m, l = sp_decode.local_partials(
            q[:, 0], kc.transpose(1, 2), vc.transpose(1, 2), kv_len, start,
            dh ** -0.5)
        acc, m, l = acc[:, None], m[:, None], l[:, None]
    else:
        acc, m, l = _sdpa_partials(q, kc, vc, lengths - start,
                                   kv_len - start)
    out = sp_decode.merge_partials(acc, m, l, tp.seq_group).to(x.dtype)
    return _split_out(p, out, cfg, tp, keep)


def _split_out(p: Params, out, cfg: ModelConfig, tp, keep: bool):
    """``out`` (b, s, h, dh') through this rank's rows of ``wo``: its
    heads or ``dh`` slice of every head are taken unless ``keep`` (``out``
    is this rank's heads already), and the partial sums leave through a
    *reduce* where ``wo`` is split."""
    b, s = out.shape[:2]
    hq, dh = cfg.n_heads, cfg.head_dim_
    wo = p["wo"]
    hl, dl = wo.shape[:2]
    if hl != hq and not keep:
        out = out.narrow(2, tp.rank * hl, hl)
    elif dl != dh:
        out = out.narrow(3, tp.rank * dl, dl)
    y = out.reshape(b, s, hl * dl) @ wo.reshape(hl * dl, wo.shape[-1])
    return tp.reduce(y) if (hl, dl) != (hq, dh) else y


def _attn_split_cross(p: Params, x, cfg: ModelConfig, cache, seg_lens, tp):
    """Cross-attention over a split cross cache on this rank's block of
    the weights.  The cache holds this rank's batch rows of the fixed
    source's K/V and, where the rule splits the KV heads over ``model``,
    its KV heads (``sharding.cache_spec``), as ``fill_source`` wrote them:

    * heads split: q on this rank's heads over its KV heads, no merge;
    * replicated K/V: q on this rank's heads over the KV heads they read
      (``ModelParallel.kv_heads``) of every KV head the cache holds;
    * ``dh`` split: q gathered over ``dh`` to every head, attention over
      the whole cache, then this rank's ``dh`` slice into ``wo``, as
      :func:`_attn_split` does.

    The kernel routes run the flash kernel on an s > 1 block and the
    dense decode kernel on a step (:func:`_source_attention`), at the
    rank's heads; ``wo``'s partial sums leave through a *reduce*."""
    b, s, d = x.shape
    wq = p["wq"]
    hl, dl = wq.shape[1:]
    q = (x @ wq.reshape(d, hl * dl)).reshape(b, s, hl, dl)
    if cfg.qkv_bias:
        q = q + p["bq"]
    kc, vc = cache["k"], cache["v"]
    if dl != cfg.head_dim_:                             # dh split
        q = tp.gather(q, 3)
    elif hl != cfg.n_heads and kc.shape[2] == cfg.n_kv_heads:
        heads = tp.kv_heads(hl)                         # replicated K/V
        kc, vc = kc[:, :, heads], vc[:, :, heads]
    out = _source_attention(q, kc, vc, cfg, False, seg_lens)
    return _split_out(p, out, cfg, tp, keep=dl == cfg.head_dim_)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def apply_mlp(p: Params, x: torch.Tensor, cfg: ModelConfig,
              tp=None) -> torch.Tensor:
    """The MLP; with ``tp`` and ``d_ff`` split over ``model`` (``wd``'s
    rows), ``wg``/``wu`` are this rank's columns and ``wd`` its rows:
    ``x`` enters through a *copy* and the partial sums leave through a
    *reduce*."""
    split = tp is not None and p["wd"].shape[0] != cfg.d_ff
    if split:
        x = tp.copy(x)
    if cfg.act == "swiglu":
        h = torch.nn.functional.silu(x @ p["wg"]) * (x @ p["wu"])
    else:
        # jax.nn.gelu defaults to the tanh form (approximate=True).
        h = torch.nn.functional.gelu(x @ p["wu"], approximate="tanh")
    y = h @ p["wd"]
    return tp.reduce(y) if split else y


# ---------------------------------------------------------------------------
# MoE (top-k routing, GShard-style dispatch)
# ---------------------------------------------------------------------------

def _route(p: Params, xf: torch.Tensor, cfg: ModelConfig,
           density_mean=None, tp=None):
    """fp32 router -> (renormalised top-k gates (t, k), expert ids (t, k),
    one-hot (t, k, e), load-balancing aux loss).

    The aux loss is e * sum(density * mean probs), not linear in the batch.
    When the batch is split evenly over data-parallel ranks,
    ``density_mean`` maps this rank's per-expert fractions (e,), which
    carry no gradient, to the whole batch's (a mean over the ranks); the
    ranks' mean aux loss, and its gradient, is then the whole batch's.
    With ``tp`` the router holds this rank's experts' columns: the fp32
    logits are gathered over ``model`` before the softmax and top-k, so
    gates, ids and the aux loss are the one-process ones on every rank."""
    e, k = cfg.n_experts, cfg.top_k
    logits = xf.float() @ p["router"]                           # (t, e)
    if tp is not None:
        logits = tp.gather(logits, -1)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, idx = torch.topk(probs, k, dim=-1)
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)
    onehot = torch.nn.functional.one_hot(idx, e).float()        # (t, k, e)
    density = onehot.sum(dim=1).mean(dim=0)
    if density_mean is not None:
        density = density_mean(density.detach())
    aux = cfg.router_aux_weight * e * torch.sum(density * probs.mean(dim=0))
    return gate_vals, idx, onehot, aux


def moe_capacity(t: int, cfg: ModelConfig) -> int:
    """Per-expert capacity of the sorted dispatch (the reference's rule)."""
    e, k = cfg.n_experts, cfg.top_k
    cap = int(-(-t * k * cfg.capacity_factor // e))
    return min(max(128, -(-cap // 128) * 128), t * k)


def sorted_slots(idx: torch.Tensor, n_experts: int, cap: int):
    """The sorted dispatch's placement of the (token, choice) pairs:
    ``(order, pos, keep, counts)``.  Pairs sort by expert with a stable
    sort (drops depend on it: within an expert the earlier token keeps its
    slot), ``pos`` is each sorted pair's rank in its expert, ``keep`` is
    ``pos < cap`` and ``counts`` (e,) the pairs each expert received."""
    eidx = idx.reshape(-1)
    order = torch.argsort(eidx, stable=True)
    counts = torch.bincount(eidx, minlength=n_experts)
    starts = counts.cumsum(0) - counts                         # exclusive
    pos = torch.arange(eidx.numel(), device=idx.device) - starts[eidx[order]]
    return order, pos, pos < cap, counts


def _expert_products(cfg: ModelConfig):
    """The grouped product ``(x (e, c, k), w (e, k, n), counts) -> (e, c,
    n)``: the grouped-GEMM kernel on the kernel routes (its plain version
    on CPU tensors), a plain einsum on ``"xla"`` (as the reference's
    einsums), which reads no counts: rows past them are zero there too."""
    if cfg.decode_kernel != "xla":
        from repro_torch.kernels.moe_gmm import ops as gmm_ops

        return gmm_ops.grouped_matmul
    return lambda x, w, counts=None: torch.einsum("ecd,edf->ecf", x, w)


def _swiglu_experts(p: Params, xe: torch.Tensor, gmm, counts=None):
    """silu(xe @ wg) * (xe @ wu) @ wd, expert by expert; without grad mode
    each intermediate is freed as soon as the next product has read it
    (in place), with it the products stay out of place for autograd."""
    g = gmm(xe, p["wg"], counts)
    if torch.is_grad_enabled():
        h = torch.nn.functional.silu(g) * gmm(xe, p["wu"], counts)
    else:
        h = torch.nn.functional.silu(g, inplace=True)
        h.mul_(gmm(xe, p["wu"], counts))
    return gmm(h, p["wd"], counts)


def apply_moe(p: Params, x: torch.Tensor, cfg: ModelConfig,
              density_mean=None, tp=None):
    """(y (b, s, d), aux loss; ``density_mean``: see :func:`_route`).  Two
    dispatch schedules (``cfg.moe_dispatch``), as in the reference:

    * ``dense``: every expert multiplies every token, masked to 0/1 before
      and combined with the gates after (``xe = mask.T[..., None] * x`` is
      exact).  Each token's output depends on that token alone, so the
      serve path's bitwise gates hold; compute is ``e / top_k`` times the
      routed work.
    * ``sorted``: capacity-based (GShard): (token, choice) pairs sort by
      expert into (e, cap, d) buffers, overflowing pairs are dropped, the
      grouped products run with ``counts = min(received, cap)`` and the
      results scatter back.  The scatter-add (``index_add_``) is not
      bitwise reproducible run to run on CUDA (atomics), so the serve
      path's bitwise gates run only under dense dispatch.

    Expert parallel (``tp`` with the experts split over ``model``): this
    rank holds experts ``[e0, e0 + e_l)`` (``e_l`` from its leaves) and
    routes as one process does (:func:`_route`).  Dense dispatch takes its
    experts' columns of the mask and the combine weights; sorted dispatch
    places the pairs with the global capacity and the global stable order
    and keeps those of its experts, so the drops are the one-process ones.
    ``x`` and the gates enter through a *copy*, and the partial outputs
    leave through a *reduce*."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    t = b * s
    e_l = p["wg"].shape[0]
    split = tp is not None and e_l != e
    e0 = tp.rank * e_l if split else 0
    xf = x.reshape(t, d)
    if split:
        xf = tp.copy(xf)
    gate_vals, idx, onehot, aux = _route(p, xf, cfg, density_mean,
                                         tp if split else None)
    if split:
        gate_vals = tp.copy(gate_vals)
    gmm = _expert_products(cfg)

    if cfg.moe_dispatch == "sorted":
        cap = moe_capacity(t, cfg)
        order, pos, keep, counts = sorted_slots(idx, e, cap)
        eidx_s = idx.reshape(-1)[order] - e0
        if split:
            keep = keep & (eidx_s >= 0) & (eidx_s < e_l)
        tok_s = torch.arange(t, device=x.device).repeat_interleave(k)[order]
        gate_s = gate_vals.reshape(-1).float()[order]
        pos_c = torch.where(keep, pos, 0)
        eidx_c = torch.where(keep, eidx_s, 0)
        # Dropped pairs add zeros at (0, 0): accumulate, never overwrite.
        xe = torch.zeros((e_l, cap, d), dtype=x.dtype, device=x.device)
        xe.index_put_((eidx_c, pos_c),
                      xf[tok_s] * keep[:, None].to(x.dtype), accumulate=True)
        live = counts[e0:e0 + e_l].clamp(max=cap).to(torch.int32)
        ye = _swiglu_experts(p, xe, gmm, live)                  # (e_l, cap, d)
        del xe
        contrib = ye[eidx_c, pos_c] * (
            gate_s * keep.float())[:, None].to(x.dtype)
        y = torch.zeros((t, d), dtype=x.dtype, device=x.device)
        y.index_add_(0, tok_s, contrib)
    else:
        mask = onehot.amax(dim=1)[:, e0:e0 + e_l]               # (t, e_l) 0/1
        combine = torch.einsum("tk,tke->te", gate_vals,
                               onehot[..., e0:e0 + e_l])        # (t, e_l)
        xe = mask.T.to(x.dtype)[:, :, None] * xf                # (e_l, t, d)
        ye = _swiglu_experts(p, xe, gmm)                        # (e_l, t, d)
        del xe
        y = torch.einsum("etd,te->td", ye, combine.to(x.dtype)).to(x.dtype)
    if split:
        y = tp.reduce(y)
    return y.reshape(b, s, d), aux


# ---------------------------------------------------------------------------
# Embedding
# ---------------------------------------------------------------------------

def _vocab_split(tp, leaf_vocab: int) -> bool:
    return tp is not None and leaf_vocab != tp.cfg.padded_vocab


def embed(p: Params, tokens: torch.Tensor, tp=None) -> torch.Tensor:
    """The token embeddings.  Vocab-parallel (``tp`` and ``tok`` this
    rank's rows): the ids in this rank's range are looked up, the rest
    give zeros, and the ranks' rows are summed by a *reduce* (exact: one
    of the addends is nonzero)."""
    tok = p["tok"]
    if not _vocab_split(tp, tok.shape[0]):
        return tok[tokens.long()]
    vl = tok.shape[0]
    ids = tokens.long() - tp.rank * vl
    mine = (ids >= 0) & (ids < vl)
    x = tok[ids.clamp(0, vl - 1)] * mine[..., None].to(tok.dtype)
    return tp.reduce(x)


def unembed(p: Params, h: torch.Tensor, cfg: ModelConfig,
            tp=None) -> torch.Tensor:
    """The logits; vocab-parallel, this rank's columns (of the tied
    ``tok``'s rows or of ``unembed``), ``h`` entering through a *copy*."""
    w = p["tok"].T if cfg.tie_embeddings else p["unembed"]
    if _vocab_split(tp, w.shape[1]):
        h = tp.copy(h)
    return h @ w


def gather_vocab(logits: torch.Tensor, tp=None) -> torch.Tensor:
    """Whole logits from this rank's vocab columns (a no-op unsplit)."""
    if not _vocab_split(tp, logits.shape[-1]):
        return logits
    return tp.gather(logits, -1)


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------

# Vocab-chunked logsumexp above this size: never materializes the fp32
# logit tensor (a 51k-vocab, 65k-token device batch would need 12.5 GiB).
_CE_CHUNK_VOCAB = 16384
# ... taken when the logits hold more elements than this (256 MiB of fp32).
_CE_CHUNK_MIN_ELEMENTS = 256 * 1024**2 // 4


def _chunk_bounds(v: int):
    return [(j, min(j + _CE_CHUNK_VOCAB, v))
            for j in range(0, v, _CE_CHUNK_VOCAB)]


def _masked_chunk(logits, lo, hi, vocab_valid):
    """Columns [lo, hi) in fp32, those at or past ``vocab_valid`` -1e30."""
    x = logits[..., lo:hi].float()
    if hi > vocab_valid:
        idx = torch.arange(lo, hi, device=logits.device)
        x = torch.where(idx < vocab_valid, x, -1e30)
    return x


def _online_lse(logits, bounds, vocab_valid: int):
    """The running (max, sum of exponentials) in fp32 over the column
    chunks ``bounds``, columns at or past ``vocab_valid`` masked."""
    lead = logits.shape[:-1]
    m = torch.full(lead, -1e30, dtype=torch.float32, device=logits.device)
    l = torch.zeros(lead, dtype=torch.float32, device=logits.device)
    for lo, hi in bounds:
        x = _masked_chunk(logits, lo, hi, vocab_valid)
        m_cur = torch.maximum(m, x.amax(dim=-1))
        l = l * torch.exp(m - m_cur) + torch.exp(
            x - m_cur[..., None]).sum(dim=-1)
        m = m_cur
    return m, l


def _softmax_chunks(logits, bounds, vocab_valid: int, logz, grad):
    """``softmax(x) * grad`` chunk by chunk from ``logz``, in the logits'
    dtype (masked columns exactly 0)."""
    dx = torch.empty_like(logits)
    for lo, hi in bounds:
        x = _masked_chunk(logits, lo, hi, vocab_valid)
        dx[..., lo:hi] = (torch.exp(x - logz[..., None])
                          * grad[..., None]).to(dx.dtype)
    return dx


class _ChunkedLogSumExp(torch.autograd.Function):
    """The reference's online logsumexp over ``_CE_CHUNK_VOCAB``-wide vocab
    chunks (the padded tail of the last chunk is simply not read: it would
    add exp(-1e30 - m) = 0).  The backward's gradient is softmax(x) chunk
    by chunk from the saved logits and result, written in the logits'
    dtype; padded columns get exactly 0."""

    @staticmethod
    def forward(ctx, logits, vocab_valid: int):
        m, l = _online_lse(logits, _chunk_bounds(logits.shape[-1]),
                           vocab_valid)
        out = m + torch.log(l.clamp_min(1e-30))
        ctx.save_for_backward(logits, out)
        ctx.vocab_valid = vocab_valid
        return out

    @staticmethod
    def backward(ctx, grad):
        logits, out = ctx.saved_tensors
        return _softmax_chunks(logits, _chunk_bounds(logits.shape[-1]),
                               ctx.vocab_valid, out, grad), None


def _chunked_logsumexp(logits: torch.Tensor, vocab_valid: int
                       ) -> torch.Tensor:
    """logsumexp over the first ``vocab_valid`` columns, in fp32, one vocab
    chunk at a time."""
    return _ChunkedLogSumExp.apply(logits, vocab_valid)


class _VocabParallelCE(torch.autograd.Function):
    """Per-token ``logsumexp(x) - x[label]`` over logits split by vocab
    columns across the ``model`` ranks (``logits`` this rank's columns
    ``[v0, v0 + vl)``).  Each rank runs the chunked online logsumexp over
    its columns (the padded tail past ``vocab_valid``, on the last rank's
    block, masked); the ranks' (max, sum of exponentials) and the target
    logit (nonzero on the rank that holds the label) are all-reduced.  The
    whole vocabulary is never materialised, and the live fp32 buffer is a
    ``_CE_CHUNK_VOCAB``-wide chunk of this rank's columns where the
    one-process loss would chunk.  The backward is ``softmax - onehot`` on
    this rank's columns, chunk by chunk, in the logits' dtype."""

    @staticmethod
    def forward(ctx, logits, labels, vocab_valid: int, tp):
        vl = logits.shape[-1]
        v0 = tp.rank * vl
        valid = vocab_valid - v0
        chunked = (logits.numel() * tp.size > _CE_CHUNK_MIN_ELEMENTS
                   and vl * tp.size > _CE_CHUNK_VOCAB)
        bounds = _chunk_bounds(vl) if chunked else [(0, vl)]
        m, l = _online_lse(logits, bounds, valid)
        m_all = tp.all_reduce_(m.clone(), torch.distributed.ReduceOp.MAX)
        l = tp.all_reduce_(l * torch.exp(m - m_all))
        logz = m_all + torch.log(l.clamp_min(1e-30))
        lab = labels.long() - v0
        mine = (lab >= 0) & (lab < vl)
        lab = lab.clamp(0, vl - 1)
        gold = torch.gather(logits, -1, lab[..., None])[..., 0].float()
        gold = tp.all_reduce_(torch.where(mine, gold, 0.0))
        ctx.save_for_backward(logits, logz, lab, mine)
        ctx.bounds, ctx.valid = bounds, valid
        return logz - gold

    @staticmethod
    def backward(ctx, grad):
        logits, logz, lab, mine = ctx.saved_tensors
        dx = _softmax_chunks(logits, ctx.bounds, ctx.valid, logz, grad)
        hit = torch.gather(dx, -1, lab[..., None])[..., 0].float()
        dx.scatter_(-1, lab[..., None], torch.where(
            mine, hit - grad, hit)[..., None].to(dx.dtype))
        return dx, None, None, None


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  vocab_valid: int, tp=None) -> torch.Tensor:
    """Mean next-token loss; padded vocab entries masked out.  With
    ``tp`` and ``logits`` this rank's vocab columns, the vocab-parallel
    loss (:class:`_VocabParallelCE`), equal on every rank."""
    if _vocab_split(tp, logits.shape[-1]):
        return _VocabParallelCE.apply(logits, labels, vocab_valid, tp).mean()
    v = logits.shape[-1]
    labels = labels.long()[..., None]
    if logits.numel() > _CE_CHUNK_MIN_ELEMENTS and v > _CE_CHUNK_VOCAB:
        logz = _chunked_logsumexp(logits, vocab_valid)
        gold = torch.gather(logits, -1, labels)[..., 0].float()
        return (logz - gold).mean()
    lf = logits.float()
    if vocab_valid < v:
        lf = torch.where(torch.arange(v, device=lf.device) < vocab_valid,
                         lf, -1e30)
    logz = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, labels)[..., 0]
    return (logz - gold).mean()


@dataclasses.dataclass
class ModelApply:
    """Bundle returned by each model module, the reference's fields plus
    the port's serving extras (``kv_pool``, ``fill_source``).

    ``forward(params, tokens, **source, remat=...)`` -> ``(logits, aux)``
    and ``loss(params, batch, remat=...)`` -> ``(loss, {"ce", "aux"})``
    train or score a whole block with no cache (``source``: ``vis=`` for
    the VLM, ``frames=`` for whisper; the MoE families' ``forward`` and
    ``loss`` also take ``density_mean=``, see :func:`_route`).  They honour ``cfg.decode_kernel``
    as every entry point does, so a kernel route under ``torch.no_grad()``
    runs the CUDA kernels; those record no autograd graph and refuse to be
    differentiated, which is why ``train.step.make_train_step`` builds its
    model on ``"xla"``.

    ``prefill``/``decode_step`` take ``seg_lens`` ((b,) int32, valid new
    tokens per slot; None = the whole block).  ``seg_lens[b] == 0`` leaves
    slot b's KV and cursor untouched.  Both update the cache's KV buffers in
    place and return ``(logits, cache)`` with the advanced cursors."""

    config: ModelConfig
    init: Any            # (generator) -> params
    forward: Any         # (params, tokens, **source, remat) -> (logits, aux)
    loss: Any            # (params, batch, remat) -> (loss, metrics)
    init_cache: Any      # (params, batch, max_len, n_pages=None, **source)
                         # -> cache; source: vis= (VLM), frames= (whisper)
    prefill: Any         # (params, cache, tokens, seg_lens, all_logits)
    decode_step: Any     # (params, cache, tokens, seg_lens)
    reset_slots: Any = None  # (cache, mask (b,) bool) -> cache, in place
    # Under FSDP the ``distributed.fsdp.DataShards`` the model gathers its
    # leaves with (which leaves split over ``data``); None otherwise.
    data_shards: Any = None
    # The path of the self-attention K/V subtree ({"k", "v"}) in the cache:
    # the page pool of a paged cache, the leaves the page table addresses.
    # None: no KV (mamba2).
    kv_pool: tuple | None = None
    # (params, cache, **source) -> None: recompute the fixed-source leaves
    # (cross K/V, and what they are made from) in place, as init_cache
    # made them.  None: the cache has none.
    fill_source: Any = None


def reset_lengths(cache: Params, mask: torch.Tensor) -> Params:
    """Rewind the ragged cursor of masked slots, in place; stale KV is
    masked and overwritten as the cursor advances.  Returns ``cache``."""
    cache["lengths"].masked_fill_(mask, 0)
    return cache


def reset_recurrent(cache: Params, mask: torch.Tensor,
                    state_keys: tuple = ("ssm", "conv")) -> Params:
    """reset_lengths plus zeroed recurrent-state leaves, all in place (no
    leaf is rebound, so a CUDA graph that captured them stays valid).
    Returns ``cache``.

    Unlike KV buffers, SSM/conv state has no validity mask: a re-admitted
    slot must start from zero state.  Each ``state_keys`` entry is a key
    (batch on axis 1, the (L, b, ...) stacked-layer layout) or a
    ``(key, axis)`` pair; every leaf's shape is checked against the mask
    before anything is written, so a layout with its batch elsewhere
    raises instead of zeroing the wrong rows.  Leaves not named (zamba2's
    "kv") pass through untouched.  The state is multiplied by the kept
    mask (``mul_``), so its values are bitwise those of ``leaf * keep``."""
    b = mask.shape[0]
    leaves = []
    for entry in state_keys:
        key, axis = entry if isinstance(entry, tuple) else (entry, 1)
        leaf = cache[key]
        if leaf.dim() <= axis or leaf.shape[axis] != b:
            raise ValueError(
                f"reset_recurrent: cache leaf '{key}' has shape "
                f"{tuple(leaf.shape)} but the batch axis ({axis}) must have "
                f"size {b}; pass (key, axis) in state_keys for this layout")
        leaves.append((leaf, axis))
    reset_lengths(cache, mask)
    keep = ~mask
    for leaf, axis in leaves:
        shape = [1] * leaf.dim()
        shape[axis] = b
        leaf.mul_(keep.to(leaf.dtype).reshape(shape))
    return cache
