"""On-device n-gram draft proposer for speculative decode (DESIGN.md §5.3),
the port of ``repro.serve.draft``.

Prompt-lookup drafting: each slot's draft is the continuation of the most
recent *earlier* occurrence of its current ``spec_ngram``-token suffix in
that slot's own history (prompt + emitted tokens).  No draft model, no
extra weights: a few gathers and compares over the engine's
(slots, max_len + 1) history buffer, with static shapes and no host sync,
so it runs inside the engine's speculative chunk and its CUDA graph.  The
reference computes it with ``jnp`` ops outside any Pallas kernel; these
are the same ops in torch.

A wrong draft costs nothing but acceptance (the verify pass rolls it back);
when no earlier occurrence exists the proposer falls back to repeating the
slot's last token, which keeps the verify pass's shape static.
"""
from __future__ import annotations

import torch


def ngram_propose(hist: torch.Tensor, hist_len: torch.Tensor,
                  ngram: int, k: int) -> torch.Tensor:
    """Draft ``k`` tokens per slot by suffix match over each slot's history.

    ``hist``: (b, H) int32 token history (prompt + emitted, including the
    not-yet-consumed current token at ``hist_len - 1``); ``hist_len``: (b,)
    int32 valid prefix lengths.  Returns (b, k) int32 drafts.

    Slot b's suffix is its last ``ngram`` tokens.  A candidate start p
    matches iff ``hist[b, p:p+ngram]`` equals the suffix and the window lies
    strictly before the suffix's own occurrence (``p < hist_len - ngram``).
    The draft is the ``k`` tokens following the LAST match (most recent
    context wins); positions past the valid prefix, and slots with no
    match or with ``hist_len < ngram``, fall back to the last token."""
    b, H = hist.shape
    dev = hist.device
    hl = hist_len.long()
    idx = torch.arange(H, device=dev)[None, :]                 # (1, H)
    # Suffix tokens hist[b, hist_len - ngram + i]; clipped gathers on short
    # histories read values that the validity mask below discards.
    suf_pos = hl[:, None] - ngram + torch.arange(ngram, device=dev)[None, :]
    suffix = torch.gather(hist, 1, suf_pos.clamp(0, H - 1))
    # match[b, p] = AND_i hist[b, p+i] == suffix[b, i], over ngram static
    # shifts of a -1-padded history (token ids are >= 0, so the pad never
    # matches).
    padded = torch.cat([hist, hist.new_full((b, ngram), -1)], dim=1)
    match = idx < (hl[:, None] - ngram)                 # p strictly earlier
    for i in range(ngram):
        match = match & (padded[:, i:i + H] == suffix[:, i:i + 1])
    p_star = torch.where(match, idx, -1).amax(dim=1)    # (b,) last match
    last = torch.gather(hist, 1, (hl - 1).clamp(0, H - 1)[:, None])
    dpos = p_star[:, None] + ngram + torch.arange(k, device=dev)[None, :]
    ok = (p_star[:, None] >= 0) & (dpos < hl[:, None])
    cont = torch.gather(hist, 1, dpos.clamp(0, H - 1))
    return torch.where(ok, cont, last).to(torch.int32)
