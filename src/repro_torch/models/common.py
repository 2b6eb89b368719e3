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
* Cross-attention, the loss and the scan-unroll switch are not ported
  yet.
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


def norm_init(cfg: ModelConfig, device) -> Params:
    p = {"w": torch.ones(cfg.d_model, device=device)}
    if cfg.norm_kind == "layer":
        p["b"] = torch.zeros(cfg.d_model, device=device)
    return p


def attn_init(gen, cfg: ModelConfig, device) -> Params:
    d = cfg.d_model
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    dt = torch_dtype(cfg.dtype)
    p = {
        "wq": dense_init(gen, (d, hq, dh), d, dt, device),
        "wk": dense_init(gen, (d, hkv, dh), d, dt, device),
        "wv": dense_init(gen, (d, hkv, dh), d, dt, device),
        "wo": dense_init(gen, (hq, dh, d), hq * dh, dt, device),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((hq, dh), dtype=dt, device=device)
        p["bk"] = torch.zeros((hkv, dh), dtype=dt, device=device)
        p["bv"] = torch.zeros((hkv, dh), dtype=dt, device=device)
    return p


def mlp_init(gen, cfg: ModelConfig, device) -> Params:
    d, f = cfg.d_model, cfg.d_ff
    dt = torch_dtype(cfg.dtype)
    if cfg.act == "swiglu":
        return {
            "wg": dense_init(gen, (d, f), d, dt, device),
            "wu": dense_init(gen, (d, f), d, dt, device),
            "wd": dense_init(gen, (f, d), f, dt, device),
        }
    return {
        "wu": dense_init(gen, (d, f), d, dt, device),
        "wd": dense_init(gen, (f, d), f, dt, device),
    }


def moe_init(gen, cfg: ModelConfig, device) -> Params:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    dt = torch_dtype(cfg.dtype)
    return {
        "router": dense_init(gen, (d, e), d, torch.float32, device),
        "wg": dense_init(gen, (e, d, f), d, dt, device),
        "wu": dense_init(gen, (e, d, f), d, dt, device),
        "wd": dense_init(gen, (e, f, d), f, dt, device),
    }


def embed_init_params(gen, cfg: ModelConfig, device) -> Params:
    v, d = cfg.padded_vocab, cfg.d_model
    dt = torch_dtype(cfg.dtype)
    p = {"tok": embed_init(gen, (v, d), dt, device)}
    if not cfg.tie_embeddings:
        p["unembed"] = dense_init(gen, (d, v), d, dt, device)
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
              seg_lens: torch.Tensor | None) -> None:
    """Scatter a (b, s, ...) block into a (b, S + 1, ...) ring, in place.

    Row i of slot b lands at position lengths[b] + i.  Invalid rows
    (i >= seg_lens[b]) and overflow (pos >= S) go to the sink position S
    (see the module docstring), never into the public [:, :S] view."""
    b, s = new.shape[:2]
    S = cache_kv.shape[1] - 1
    dev = cache_kv.device
    pos = lengths.long()[:, None] + torch.arange(s, device=dev)[None, :]
    drop = pos >= S
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


def apply_attn(
    p: Params,
    x: torch.Tensor,                  # (b, s, d)
    cfg: ModelConfig,
    positions: torch.Tensor,          # (b, s)
    cache: Params,                    # {"k","v" (with sink), "lengths", ["pages"]}
    seg_lens: torch.Tensor | None = None,  # (b,) valid new tokens per slot
) -> torch.Tensor:
    """Causal self-attention over a ragged KV cache.  Appends this block's
    K/V to the cache buffers in place and returns the (b, s, d) output."""
    b, s, d = x.shape
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    q = (x @ p["wq"].reshape(d, hq * dh)).reshape(b, s, hq, dh)
    k = (x @ p["wk"].reshape(d, hkv * dh)).reshape(b, s, hkv, dh)
    v = (x @ p["wv"].reshape(d, hkv * dh)).reshape(b, s, hkv, dh)
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)

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


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def apply_mlp(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if cfg.act == "swiglu":
        h = torch.nn.functional.silu(x @ p["wg"]) * (x @ p["wu"])
    else:
        h = torch.nn.functional.gelu(x @ p["wu"])
    return h @ p["wd"]


# ---------------------------------------------------------------------------
# MoE (top-k routing, GShard-style dispatch)
# ---------------------------------------------------------------------------

def _route(p: Params, xf: torch.Tensor, cfg: ModelConfig):
    """fp32 router -> (renormalised top-k gates (t, k), expert ids (t, k),
    one-hot (t, k, e), load-balancing aux loss)."""
    e, k = cfg.n_experts, cfg.top_k
    probs = torch.softmax(xf.float() @ p["router"], dim=-1)     # (t, e)
    gate_vals, idx = torch.topk(probs, k, dim=-1)
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)
    onehot = torch.nn.functional.one_hot(idx, e).float()        # (t, k, e)
    density = onehot.sum(dim=1).mean(dim=0)
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
    """silu(xe @ wg) * (xe @ wu) @ wd, expert by expert; each intermediate
    is freed as soon as the next product has read it."""
    h = torch.nn.functional.silu(gmm(xe, p["wg"], counts), inplace=True)
    h.mul_(gmm(xe, p["wu"], counts))
    return gmm(h, p["wd"], counts)


def apply_moe(p: Params, x: torch.Tensor, cfg: ModelConfig):
    """(y (b, s, d), aux loss).  Two dispatch schedules
    (``cfg.moe_dispatch``), as in the reference:

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
      path's bitwise gates run only under dense dispatch."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    t = b * s
    xf = x.reshape(t, d)
    gate_vals, idx, onehot, aux = _route(p, xf, cfg)
    gmm = _expert_products(cfg)

    if cfg.moe_dispatch == "sorted":
        cap = moe_capacity(t, cfg)
        order, pos, keep, counts = sorted_slots(idx, e, cap)
        eidx_s = idx.reshape(-1)[order]
        tok_s = torch.arange(t, device=x.device).repeat_interleave(k)[order]
        gate_s = gate_vals.reshape(-1).float()[order]
        pos_c = torch.where(keep, pos, 0)
        eidx_c = torch.where(keep, eidx_s, 0)
        # Dropped pairs add zeros at (0, 0): accumulate, never overwrite.
        xe = torch.zeros((e, cap, d), dtype=x.dtype, device=x.device)
        xe.index_put_((eidx_c, pos_c),
                      xf[tok_s] * keep[:, None].to(x.dtype), accumulate=True)
        live = counts.clamp(max=cap).to(torch.int32)
        ye = _swiglu_experts(p, xe, gmm, live)                  # (e, cap, d)
        del xe
        contrib = ye[eidx_c, pos_c] * (
            gate_s * keep.float())[:, None].to(x.dtype)
        y = torch.zeros((t, d), dtype=x.dtype, device=x.device)
        y.index_add_(0, tok_s, contrib)
        return y.reshape(b, s, d), aux

    mask = onehot.amax(dim=1)                                   # (t, e) 0/1
    combine = torch.einsum("tk,tke->te", gate_vals, onehot)     # (t, e)
    xe = mask.T.to(x.dtype)[:, :, None] * xf                    # (e, t, d)
    ye = _swiglu_experts(p, xe, gmm)                            # (e, t, d)
    del xe
    y = torch.einsum("etd,te->td", ye, combine.to(x.dtype))
    return y.reshape(b, s, d).to(x.dtype), aux


# ---------------------------------------------------------------------------
# Embedding
# ---------------------------------------------------------------------------

def embed(p: Params, tokens: torch.Tensor) -> torch.Tensor:
    return p["tok"][tokens.long()]


def unembed(p: Params, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if cfg.tie_embeddings:
        return h @ p["tok"].T
    return h @ p["unembed"]


@dataclasses.dataclass
class ModelApply:
    """Bundle returned by each model module (the serving subset of the
    reference's: no ``forward``/``loss`` until training is ported).

    ``prefill``/``decode_step`` take ``seg_lens`` ((b,) int32, valid new
    tokens per slot; None = the whole block).  ``seg_lens[b] == 0`` leaves
    slot b's KV and cursor untouched.  Both update the cache's KV buffers in
    place and return ``(logits, cache)`` with the advanced cursors."""

    config: ModelConfig
    init: Any            # (generator) -> params
    init_cache: Any      # (params, batch, max_len, n_pages=None) -> cache
    prefill: Any         # (params, cache, tokens, seg_lens, all_logits)
    decode_step: Any     # (params, cache, tokens, seg_lens)
    reset_slots: Any = None  # (cache, mask (b,) bool) -> cache


def reset_lengths(cache: Params, mask: torch.Tensor) -> Params:
    """Rewind the ragged cursor of masked slots; stale KV is masked and
    overwritten as the cursor advances."""
    cache = dict(cache)
    cache["lengths"] = torch.where(
        mask, 0, cache["lengths"]).to(torch.int32)
    return cache


def reset_recurrent(cache: Params, mask: torch.Tensor,
                    state_keys: tuple = ("ssm", "conv")) -> Params:
    """reset_lengths plus zeroed recurrent-state leaves.

    Unlike KV buffers, SSM/conv state has no validity mask: a re-admitted
    slot must start from zero state.  Each ``state_keys`` entry is a key
    (batch on axis 1, the (L, b, ...) stacked-layer layout) or a
    ``(key, axis)`` pair; the leaf's shape is checked against the mask so a
    layout with its batch elsewhere raises instead of zeroing the wrong
    rows.  Leaves not named (zamba2's "kv") pass through untouched."""
    out = reset_lengths(cache, mask)
    b = mask.shape[0]
    keep = ~mask
    for entry in state_keys:
        key, axis = entry if isinstance(entry, tuple) else (entry, 1)
        leaf = cache[key]
        if leaf.dim() <= axis or leaf.shape[axis] != b:
            raise ValueError(
                f"reset_recurrent: cache leaf '{key}' has shape "
                f"{tuple(leaf.shape)} but the batch axis ({axis}) must have "
                f"size {b}; pass (key, axis) in state_keys for this layout")
        shape = [1] * leaf.dim()
        shape[axis] = b
        out[key] = leaf * keep.to(leaf.dtype).reshape(shape)
    return out
