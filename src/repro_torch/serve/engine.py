"""Continuous-batching serve engine over a paged (or contiguous) KV cache,
with prefix sharing, the request lifecycle, speculative decode, the
adaptive serve-tier cache policy, seeded sampling, crash safety and KV page
integrity: the port of ``repro.serve.engine``.

* **Chunked decode with one host sync per chunk.**  A chunk is
  ``chunk_size`` single-token decode steps with on-device sampling
  (``serve.sampling``: greedy, or temperature / top-k / top-p keyed by
  each request's ``(seed, token index)``); tokens, budgets, token indices
  and done flags stay on the device, and the chunk's emitted tokens come
  back in one device-to-host copy.
* **The chunk as one CUDA graph** (``cuda_graph=True``, the default on the
  card; the reference's ``jit(scan)`` with donation).  The chunk's body
  reads and writes only static buffers: the cache's leaves, ``cur_tok``,
  ``remaining``, ``seeds``, ``tok_idx`` and a (2, chunk_size, slots)
  output of tokens and active flags.  It is captured once per engine, at
  construction, after a warm-up on a side stream (which builds the kernels
  at first use), both with every slot parked, so neither changes any
  state; ``_run_chunk`` then replays it and copies the output to the host.
  Every other write to those buffers (admission's prefill, slot resets,
  parking, the page table, a restore's reset) is in place, and before each
  chunk ``_check_static`` raises if a leaf was rebound or the split count
  moved from the one captured.  A failed capture or replay raises; nothing
  falls back to the eager loop, which runs on the CPU and with
  ``cuda_graph=False`` (the A/B arm).
* **Ragged slots.**  Finished slots park (``seg_lens == 0`` leaves their KV
  and cursor untouched, including through the kernels, which still run
  for them with ``kv_len = lengths`` and ``q_len = 0``); freed slots take
  new prompts mid-stream through a right-padded ragged prefill.
* **In-place state.**  The reference donates the cache and loop vectors to
  each jitted dispatch; here the model writes the KV and recurrent buffers
  in place, and the engine copies the cursors, tokens and budgets the
  model and sampler return back into its static buffers.
* **Paged KV pool.**  A host-side refcounted ``PageAllocator`` assigns each
  admitted request the pages its worst case needs; admission is FIFO
  head-of-line gated on free pages.
* **Prefix sharing** (``cfg.prefix_sharing``, DESIGN.md §5.4).  A host-side
  radix trie over full prompt pages (``serve.prefix``) lets admission
  attach a request to resident prefix pages: the slot's page table aliases
  them (a refcount bump), and the prefill runs only over the unshared
  suffix with the slot's cursor at ``start_lens`` (RoPE positions and the
  scatter start there; the flash kernel reads the shared pages in place).
  Sharing is capped so the prompt's last token is always re-prefilled.
* **Request lifecycle** (``cfg.preemption``, DESIGN.md §5.5).  Requests
  move through queued -> resident -> {finished, preempted -> re-queued,
  cancelled, expired}.  A page-gated head preempts the youngest
  never-preempted resident, whose pages release refcount-aware and who
  re-enters at the queue front to be restored by a recompute prefill over
  prompt + emitted tokens, sampling from token index ``len(generated)``
  (so the restored stream is the same stream).  ``cancel()`` and deadlines
  are swept at chunk boundaries, ``max_queue`` rejects with a reason,
  ``check_invariants()`` audits the slot/queue/allocator/trie state (after
  every wave under chaos or ``strict_invariants``), and ``drain()`` raises
  ``NoProgressError`` when it stops making progress.  With
  ``preemption=False`` a gated head waits.
* **Chaos** (``serve.chaos``).  Seeded alloc and share refusals, forced
  preemptions, page corruption and crash points, drawn as the reference
  draws them.
* **Crash safety** (DESIGN.md §5.6, ``serve.snapshot``).  ``snapshot(path)``
  writes host-side truth only (requests, tokens, seeds, refcounts,
  quarantine, counters, adaptive state) as checksummed JSON;
  ``restore(path)`` validates it, resets every static buffer in place (the
  captured graph stays valid) and re-admits the in-flight requests, whose
  KV the ordinary recompute prefill rebuilds.  An optional fsync'd request
  journal (``journal_path``) replays submissions and terminations past the
  snapshot.  Snapshots and journals are the reference's format, so either
  package restores the other's.
* **KV page integrity** (``cfg.kv_integrity``, DESIGN.md §5.6).  At each
  chunk boundary the engine stamps the fingerprints of pages sealed below
  their slots' cursors and verifies every stamp; a mismatch quarantines
  the page and preempts every slot mapping it, so re-admission recomputes
  its KV.  The fingerprints are computed on the device (an int8 product
  of each page's bytes, ``_fingerprint_pool``); one device-to-host copy of
  the mismatch flags a sweep is the only transfer.
* **Cache policy** (``repro_torch.core``).  The policy engine
  (``make_engine()``: the H100 model unless the caller passes another)
  sets the KV residency of the pool actually allocated and plans the
  decode-attention op at every admission wave (a PlanCache hit after the
  first); its plan sets the decode kernels' split count, baked into the
  config before the model is built.  ``policy_report()`` returns these
  decisions with the pool, sharing, lifecycle and integrity state.
* **Recurrent families** (mamba2, zamba2).  Re-admission zeroes a slot's
  SSM state and conv window (``reset_slots``); a paged config whose cache
  has no pages (mamba2) runs contiguous bookkeeping.
* **Speculative decode** (``cfg.spec_k > 0``, DESIGN.md §5.3).  A chunk is
  ``spec_rounds = max(1, chunk_size // (spec_k + 1))`` draft/verify/
  rollback rounds.  ``serve.draft.ngram_propose`` drafts ``spec_k`` tokens
  per slot from a static (slots, max_len + 1) history, plus a sink column
  (admission seeds it with the full effective prompt and the first
  token); one ragged
  ``prefill(seg_lens = spec_k + 1, all_logits=True)`` scores
  ``[cur_tok, drafts]``; each slot emits ``min(matching prefix + 1,
  remaining)`` targets, the target at position j sampled with the key of
  token index ``tok_idx + j``, so a speculative stream is the plain one
  under every sampling mode.  Rollback: KV families rewind the cursor
  (rejected KV is stale but masked); recurrent families, whose model
  writes its SSM state and conv window in place, restore them from a
  static scratch copy taken before the verify and replay the block with
  ``seg_lens = accepted``.  The body reads and writes only static buffers,
  so with ``cuda_graph`` the whole chunk is one graph replay and one
  device-to-host copy, as the plain chunk is.
* **Adaptive policy** (``cfg.adaptive``, DESIGN.md §5.7,
  ``serve.adaptive``).  Placement only: warm retention of prefix pages
  past refcount zero (bounded by ``cfg.warm_pages``, reclaimed before any
  preemption), the cost-aware preemption victim and per-class re-plans
  over ``core.sweep.SERVE_COMBOS``.  It moves pages and slots, never
  tokens; a revive writes the host page table, which admission copies
  into the device table in place, so nothing is recaptured.
* **Fixed-source families** (whisper's encoder-decoder, the VLM's
  cross-attention).  ``extras`` gives each slot its source: ``frames``
  (slots, enc_seq, d) or ``vis`` (slots, n_vis, d), numpy or tensors.  The
  source belongs to the slot, not the request, as in the reference.  The
  cross K/V (and the VLM's projected ``"vis"``) are static buffers,
  filled at construction before the chunk is captured and recomputed in
  place by a restore; prefix sharing stays off for them (a prefix's KV
  depends on its slot's source).
"""
from __future__ import annotations

import collections
import dataclasses
import os
import time

import numpy as np
import torch

from repro_torch import hw
from repro_torch.configs.base import ModelConfig
from repro_torch.core import CachePolicyEngine, make_engine
from repro_torch.core.characterize import attention_op
from repro_torch.device import resolve_device
from repro_torch.kernels import counters
from repro_torch.kernels.decode_attention.ops import plan_splits
from repro_torch.models import build_model
from repro_torch.models.common import paged_kv_spec
from repro_torch.serve.adaptive import AdaptivePolicy
from repro_torch.serve import snapshot as snap
from repro_torch.serve.alloc import PageAllocator
from repro_torch.serve.chaos import ChaosAllocator, ChaosCrash
from repro_torch.serve.draft import ngram_propose
from repro_torch.serve.prefix import PrefixIndex
from repro_torch.serve.sampling import Sampler, sample_keys
from repro_torch.serve.snapshot import SnapshotError  # noqa: F401  (re-export)


@dataclasses.dataclass
class Request:
    prompt: np.ndarray            # (len,) int32
    max_new_tokens: int = 16
    seed: int | None = None       # sampling seed (None -> 0): a stream
                                  # depends on (seed, token index) only
    id: str | None = None         # cancellation handle; auto-assigned at
                                  # submit when None ("req-<n>")
    deadline_s: float | None = None       # submit -> finish SLO; a resident
                                          # request past it expires at the
                                          # next sweep
    max_queue_wait_s: float | None = None  # submit -> admission bound
    generated: list = dataclasses.field(default_factory=list)
    slot: int = -1
    done: bool = False            # terminal: finished, cancelled or expired
    status: str = "new"           # new -> queued -> resident -> {finished,
                                  # preempted (re-queued), cancelled, expired}
    cancel_requested: bool = False  # set by cancel(); honoured at the next
                                    # lifecycle sweep (a chunk boundary)
    preempted_n: int = 0          # times evicted mid-stream
    admit_seq: int = -1           # admission order; the preemption victim
                                  # is the youngest (max) resident
    prefix_tokens: int = 0        # prompt tokens attached from shared pages
                                  # at admission (0 = fully prefilled)
    adaptive_key: str | None = None    # workload class of the prompt
                                       # (adaptive engines, at admission)
    adaptive_class: str | None = None  # the class deciding its retention;
                                       # a readmission keeps it
    ttft_s: float | None = None        # first admission -> first token
    queue_wait_s: float | None = None  # submit -> first admission
    submit_t: float | None = None
    admit_t: float | None = None


# Stats that describe the engine (its captured chunk), not a run: a
# restore keeps them.
_ENGINE_STATS = ("captured_launches", "graph_pool_bytes")


class AdmissionReject(ValueError):
    """A request the engine refuses to enqueue, with a machine-readable
    ``reason``: backpressure ("queue_full") or a request that could never
    be served ("max_len", "empty_prompt", "zero_budget", "pool_too_small",
    "duplicate_id").  Raised by ``submit`` before anything in the batch is
    enqueued."""

    def __init__(self, reason: str, message: str):
        super().__init__(message)
        self.reason = reason


class NoProgressError(RuntimeError):
    """``drain()`` watchdog: raised after ``no_progress_limit`` consecutive
    steps in which work remained but no token was emitted and no request
    changed state (e.g. injected alloc-failure rates that starve every
    admission).  The message carries the gating state."""


def _pad_bucket(n: int, cap: int) -> int:
    """Round a prefill width up to a power of two (>= 8), capped at max_len."""
    b = 8
    while b < n:
        b *= 2
    return min(b, cap)


def _leaves(tree, path=()):
    """(path, tensor) for every tensor in a nest of dicts and lists, in
    insertion order."""
    if isinstance(tree, torch.Tensor):
        yield path, tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))


def _check_chaos_rates(cfg: ModelConfig) -> None:
    for knob in ("chaos_alloc_fail_p", "chaos_share_fail_p",
                 "chaos_preempt_p"):
        if not 0.0 <= getattr(cfg, knob) < 1.0:
            raise ValueError(f"{knob} must be in [0, 1): at 1 the loop "
                             "can never make progress")


class ServeEngine:
    """Continuous-batching engine over a fixed pool of request slots.

    ``run(requests)`` (or ``submit`` + ``drain``) pushes requests through a
    queue: free slots are prefilled (ragged, right-padded, attached to
    shared prefix pages where they can be), live slots decode in
    device-resident chunks (plain single-token steps, or draft/verify/
    rollback rounds when ``cfg.spec_k > 0``), each token sampled on the
    device by ``cfg.sampling`` with the request's ``(seed, token index)``
    keys, finished slots free at chunk boundaries and are re-admitted from
    the queue.  Every step ends on a chunk boundary that is verified
    (``cfg.kv_integrity``) and journaled (``journal_path``);
    ``snapshot``/``restore`` carry the host-side state across a crash.

    ``cuda_graph`` (default True) replays each decode chunk, plain or
    speculative, as one CUDA graph on the card; it has no effect on the
    CPU.  False runs the same
    chunk eagerly on the card: the A/B arm, never chosen automatically."""

    def __init__(self, cfg: ModelConfig, params, batch_slots: int,
                 max_len: int, chunk_size: int = 8,
                 n_pages: int | None = None, max_queue: int | None = None,
                 journal_path: str | None = None,
                 no_progress_limit: int = 256, device=None,
                 policy_engine: CachePolicyEngine | None = None,
                 cuda_graph: bool = True, extras: dict | None = None):
        self.device = resolve_device(device)
        _check_chaos_rates(cfg)
        if cfg.n_experts and cfg.moe_dispatch != "dense":
            raise ValueError(
                "ServeEngine requires moe_dispatch='dense': under 'sorted', "
                "right-pad and parked-slot tokens contend with real tokens "
                "for expert capacity and silently drop them")
        self.sampler = Sampler.from_config(cfg)
        self.params = params
        self.slots = batch_slots
        self.max_len = max_len
        self.chunk_size = max(1, chunk_size)
        self.paged = cfg.cache_layout == "paged"
        self.cfg = cfg
        # Speculative decode (DESIGN.md §5.3): spec_k drafts verified a
        # round, 1..spec_k + 1 tokens emitted; a chunk packs enough rounds
        # for ~chunk_size tokens a host sync at full acceptance.
        self.spec = cfg.spec_k > 0
        self.spec_k = cfg.spec_k
        self.spec_ngram = cfg.spec_ngram
        self.spec_rounds = max(1, self.chunk_size // (cfg.spec_k + 1))
        if self.paged:
            psz = cfg.kv_page_size
            if max_len % psz:
                raise ValueError(
                    f"max_len={max_len} must be a multiple of "
                    f"kv_page_size={psz} so the gathered page view matches "
                    "the contiguous ring")
            self.page_size = psz
            self.pages_per_slot, self.n_pages = paged_kv_spec(
                batch_slots, max_len, psz, n_pages)
        # The cache policy engine (DESIGN.md §5): KV residency for the pool
        # actually allocated, and the decode-attention plan, memoized in the
        # engine's PlanCache (one lattice search a serve process, a hit for
        # every later admission wave).
        self.policy = policy_engine or make_engine()
        self.kv_residency = self.policy.kv_policy(self._kv_bytes_per_layer())
        self.decode_plan = self._plan_decode()
        # The decode kernels' split count: the decode plan's (one split per
        # planned KV block), baked into the config the model is built with;
        # cfg.decode_splits == 0 means "let the plan decide", and an
        # explicit count wins.
        self.decode_splits = self._decode_kernel_splits()
        if cfg.decode_kernel != "xla" and cfg.decode_splits == 0:
            cfg = dataclasses.replace(cfg, decode_splits=self.decode_splits)
            self.cfg = cfg
        self.model = build_model(cfg, self.device)
        # Each slot's fixed source (encoder frames, vision tokens) on the
        # device, kept for a restore's recompute.
        self.extras = {
            k: (v if isinstance(v, torch.Tensor)
                else torch.from_numpy(np.array(v))).to(self.device)
            for k, v in (extras or {}).items()}
        # The static buffers: allocated once, in inference mode (so a write
        # outside it raises), and only ever written in place.
        with torch.inference_mode():
            self.cache = self.model.init_cache(
                params, batch=batch_slots, max_len=max_len,
                n_pages=self.n_pages if self.paged else None, **self.extras)
            # Device-resident per-slot loop state: last sampled token,
            # remaining budget (0 == parked or free), the request's
            # sampling seed and the stream index of its next token, and
            # the chunk's output, tokens over active flags.
            self.cur_tok = torch.zeros(batch_slots, dtype=torch.int32,
                                       device=self.device)
            self.remaining = torch.zeros_like(self.cur_tok)
            self.seeds = torch.zeros_like(self.cur_tok)
            self.tok_idx = torch.zeros_like(self.cur_tok)
            self._out = torch.zeros((2, self.chunk_size, batch_slots),
                                    dtype=torch.int32, device=self.device)
            if self.spec:
                self._init_spec_buffers()
        # A cache with no KV to page (mamba2's decode state is O(1) per
        # slot) falls back to contiguous bookkeeping: no allocator, no page
        # table, no admission gated on a phantom pool.
        if self.paged and "pages" not in self.cache:
            self.paged = False
            self.kv_residency = self.policy.kv_policy(
                self._kv_bytes_per_layer())
        if self.paged:
            self.allocator = self._make_allocator()
            self.page_table = np.full(
                (batch_slots, self.pages_per_slot), -1, np.int32)
            self._slot_pages: list[list[int]] = [[] for _ in range(batch_slots)]
        # Prefix sharing rides the paged pool, pure-KV decoders only: the
        # recurrent state of mamba2/zamba2 is not page-shareable, and an
        # encdec/VLM prefix's KV depends on its slot's source.
        self.prefix_sharing = (bool(cfg.prefix_sharing) and self.paged
                               and cfg.family in ("dense", "moe"))
        self.prefix = (PrefixIndex(self.page_size) if self.prefix_sharing
                       else None)
        # The adaptive serve-tier policy (DESIGN.md §5.7): warm retention
        # needs re-attachable page KV (paged + prefix sharing); other
        # engines keep the cost-aware victim and the re-plans only.
        self.adaptive: AdaptivePolicy | None = None
        if cfg.adaptive:
            self.adaptive = AdaptivePolicy(
                warm_pages=cfg.warm_pages if self.prefix is not None else 0,
                replan_every=cfg.adaptive_replan_every,
                page_size=self.page_size if self.paged else 1,
                spec_k=self.spec_k if self.spec else 0)
        self._warm_tier = (self.adaptive is not None
                           and self.adaptive.warm_pages > 0
                           and self.prefix is not None)
        self.slot_req: list[Request | None] = [None] * batch_slots
        self.queue: collections.deque[Request] = collections.deque()
        # Request lifecycle (DESIGN.md §5.5).
        self.preemption = bool(cfg.preemption)
        self.max_queue = max_queue          # None = unbounded submission
        self._by_id: dict[str, Request] = {}
        self._next_id = 0
        self._admit_seq = 0
        # Slots vacated mid-stream (preempt/cancel/expire) whose device
        # budget must be zeroed before the next chunk: a stale budget would
        # decode into pages now owned by others.
        self._dirty_slots: set[int] = set()
        self._chaos_rng = (np.random.default_rng(cfg.chaos_seed)
                           if cfg.chaos_preempt_p > 0.0 else None)
        # Any chaos knob, or strict mode, arms the per-wave invariant check.
        self._chaos = cfg.chaos_preempt_p > 0.0 or (
            self.paged and (cfg.chaos_alloc_fail_p > 0.0
                            or cfg.chaos_share_fail_p > 0.0
                            or cfg.chaos_corrupt_p > 0.0))
        self._strict = cfg.strict_invariants or (
            os.environ.get("REPRO_STRICT_INVARIANTS", "") not in ("", "0"))
        # KV page integrity (DESIGN.md §5.6): fingerprints stamped at chunk
        # boundaries over pages sealed below their slot's host-computed
        # cursor, every stamp verified each step.  The stamps live on the
        # device; the host keeps the set of stamped pages.
        self.integrity = self.paged and (cfg.kv_integrity
                                         or cfg.chaos_corrupt_p > 0.0)
        self._stamped: set[int] = set()
        if self.integrity:
            self._init_fingerprints()
        self._corrupt_rng = (np.random.default_rng(cfg.chaos_seed + 0x5EED)
                             if self.paged and cfg.chaos_corrupt_p > 0.0
                             else None)
        # Crash safety (DESIGN.md §5.6): the optional fsync'd request
        # journal; _replaying keeps restore's re-enqueues out of it.
        self.journal_path = journal_path
        self.journal = (snap.RequestJournal(journal_path)
                        if journal_path is not None else None)
        self._replaying = False
        self.no_progress_limit = max(1, no_progress_limit)
        self.stats = {
            "host_syncs": 0,          # device->host copies (1/wave, 1/chunk,
                                      # 1/integrity sweep)
            "decode_tokens": 0,       # tokens emitted by decode chunks
            "prefill_tokens": 0,      # first tokens emitted by prefill
            "chunks": 0,
            "admission_waves": 0,
            "peak_pages_held": 0,     # max concurrent pool usage (paged)
            "admitted_fresh": 0,      # first-time admissions
            "readmitted": 0,          # preemption-restore re-admissions
            "prefill_work_tokens": 0,  # suffix tokens actually prefilled
            "prefix_hits": 0,         # admissions that attached shared pages
            "prefix_hits_fresh": 0,   # ... the fresh-admission subset
            "prefix_pages_shared": 0,  # shared-page references taken
            "prefix_tokens_shared": 0,  # prompt tokens not re-prefilled
            "preempted": 0,           # mid-stream evictions (incl. forced)
            "preempted_forced": 0,    # chaos-forced subset
            "recompute_tokens": 0,    # emitted tokens re-prefilled at restore
            "cancelled": 0,           # terminal via cancel()
            "expired": 0,             # terminal via deadline/queue-wait
            "rejected": 0,            # submissions refused (AdmissionReject)
            "deadline_total": 0,      # deadlined requests reaching terminal
            "deadline_met": 0,        # ... that finished within deadline
            "invariant_checks": 0,    # check_invariants() sweeps run
            "spec_rounds": 0,         # active draft/verify rounds
            "draft_proposed": 0,      # usable drafts of active rounds
            "draft_accepted": 0,      # ... the accepted (emitted) subset
            "spec_tokens": 0,         # tokens emitted by draft/verify rounds
            "warm_retained": 0,       # pages parked in the warm tier
            "warm_reclaimed": 0,      # warm pages returned to the free list
            "warm_hits": 0,           # admissions that revived warm pages
            "warm_tokens_saved": 0,   # prompt tokens attached from warm pages
            "replans": 0,             # adaptive lattice re-plans run
            "integrity_sweeps": 0,    # fingerprint stamp + verify passes
            "corrupted_pages": 0,     # fingerprint mismatches detected
            "healed_requests": 0,     # slots recompute-restored after
                                      # mapping a corrupted page
            "injected_corruptions": 0,  # chaos_corrupt_p flips landed
            "snapshots": 0,           # snapshot() calls
            "restores": 0,            # restore() calls completed
            "graph_replays": 0,       # chunks run as a CUDA graph replay
            "captured_launches": 0,   # kernel launches in the captured chunk
            "graph_pool_bytes": 0,    # memory the capture reserved
        }
        self.cuda_graph = bool(cuda_graph) and self.device.type == "cuda"
        self._graph = None
        self._graph_delta: dict[str, int] = {}
        if self.cuda_graph:
            self._capture()
        # Every buffer the chunk reads or writes, by address: the guard
        # holds the eager chunk (CPU, cuda_graph=False) to the graph's rule.
        self._static = self._static_ptrs()
        self._static_splits = (self.decode_splits, self.cfg.decode_splits)

    def _make_allocator(self) -> PageAllocator:
        """The pool allocator; the chaos wrapper when an alloc or share
        refusal rate is set (seeded as the reference seeds it)."""
        cfg = self.cfg
        warm = cfg.warm_pages if cfg.adaptive else 0
        if cfg.chaos_alloc_fail_p > 0.0 or cfg.chaos_share_fail_p > 0.0:
            return ChaosAllocator(self.n_pages, cfg.chaos_alloc_fail_p,
                                  cfg.chaos_seed,
                                  share_fail_p=cfg.chaos_share_fail_p,
                                  warm_budget=warm)
        return PageAllocator(self.n_pages, warm_budget=warm)

    def _init_spec_buffers(self) -> None:
        """The speculative chunk's static buffers, allocated once: the
        per-slot token history the proposer mines (prompt + emitted, the
        unconsumed current token included: at most max_len + 1 entries,
        plus one sink column that absorbs the writes of rejected
        positions), its valid length, the chunk's output (per round and
        slot: the k + 1 targets, the emit mask, accepted and usable drafts,
        the active flag; one device-to-host copy), and for recurrent
        families a scratch copy of every SSM state and conv window leaf,
        which the verify advances in place of the live ones."""
        b, k1, dev = self.slots, self.spec_k + 1, self.device
        self.hist = torch.zeros((b, self.max_len + 2), dtype=torch.int32,
                                device=dev)
        self.hist_len = torch.zeros(b, dtype=torch.int32, device=dev)
        self._spec_out = torch.zeros((self.spec_rounds, b, 2 * k1 + 3),
                                     dtype=torch.int32, device=dev)
        self._spec_scratch = {key: torch.empty_like(self.cache[key])
                              for key in ("ssm", "conv") if key in self.cache}
        # Recurrent state has no per-position validity mask, so its
        # rollback is a replay; KV-only families rewind the cursor.
        self._spec_replay = bool(self._spec_scratch)

    def _init_fingerprints(self) -> None:
        """The integrity sweep's device buffers: an int8 multiplier over a
        page's bytes (columns 0-3 sum each byte lane of the page's 4-byte
        words, so any single changed word changes a column; columns 4-7
        weigh every byte by a seeded odd factor) and the stamps, one row
        of int64 column sums per page (the sink included) and pool leaf."""
        leaves = self._pool_leaves()
        page_bytes = leaves[0][(0,) * (leaves[0].dim() - 3)].nbytes
        if page_bytes % 8:
            raise ValueError(
                f"kv_integrity: a page holds {page_bytes} bytes a layer; "
                "the on-device fingerprint needs a multiple of 8")
        lane = np.arange(page_bytes) % 4
        mult = np.zeros((page_bytes, 8), np.int8)
        mult[np.arange(page_bytes), lane] = 1
        rng = np.random.default_rng(0xF1A6)
        mult[:, 4:] = 2 * rng.integers(-63, 64, (page_bytes, 4)) + 1
        # Column-major, as the int8 GEMM takes its right operand.
        mult = torch.from_numpy(mult).to(self.device)
        self._fp_mult = mult.t().contiguous().t()
        self._fp_stamp = torch.zeros((self.n_pages + 1, 8 * len(leaves)),
                                     dtype=torch.int64, device=self.device)

    @property
    def free_pages(self) -> list[int]:
        """Free-list view (paged only)."""
        return self.allocator.free_pages

    # -- cache policy --------------------------------------------------------

    def _kv_bytes_per_layer(self) -> int:
        """Real per-layer KV footprint, so residency planning sees the bytes
        actually allocated: the paged pool's n_pages x page_size positions,
        not the contiguous worst case of slots x max_len."""
        kv_heads = max(1, self.cfg.n_kv_heads)
        positions = (self.n_pages * self.page_size if self.paged
                     else self.slots * self.max_len)
        return (2 * positions * kv_heads
                * self.cfg.head_dim_ * hw.dtype_bytes(self.cfg.dtype))

    def _plan_decode(self):
        if not (self.cfg.n_heads and self.cfg.head_dim_):
            return None
        return self.policy.plan_op(attention_op(
            self.slots, self.cfg.n_heads, max(1, self.cfg.n_kv_heads),
            1, self.max_len, self.cfg.head_dim_, causal=False,
            name="serve_decode",
        ))

    def _decode_kernel_splits(self) -> int:
        """Split-K parallelism for the decode kernels, planned from
        ``decode_plan`` (one split per engine-planned KV block) unless the
        config pins an explicit count.  Paged engines split over logical
        pages (the kernel's KV block is one page); contiguous ones over
        the ring."""
        if self.cfg.decode_splits:
            return self.cfg.decode_splits
        if self.paged:
            s, bkv = self.pages_per_slot * self.page_size, self.page_size
        else:
            s, bkv = self.max_len, min(512, self.max_len)
        return plan_splits(s, bkv, plan=self.decode_plan)

    def policy_report(self) -> dict:
        """Serving-side policy decisions (DESIGN.md §5) and planner
        counters, in the reference's sections."""
        report = {
            "kv_bytes_per_layer": self._kv_bytes_per_layer(),
            "kv_residency": self.kv_residency.value,
            # Effective layout: "contiguous" when a paged request met a
            # cache family with no KV to page.
            "cache_layout": "paged" if self.paged else "contiguous",
            "sampling": self.sampler.mode,
            "plan_cache": self.policy.plan_stats(),
        }
        if self.spec:
            report["speculative"] = {
                "spec_k": self.spec_k,
                "spec_ngram": self.spec_ngram,
                "rounds_per_chunk": self.spec_rounds,
                "rollback": "replay" if self._spec_replay else "rewind",
            }
        if self.paged:
            report["paged_kv"] = {
                "n_pages": self.n_pages,
                "page_size": self.page_size,
                "free_pages": self.allocator.free_count(),
                "pool_positions": self.n_pages * self.page_size,
                "contiguous_positions": self.slots * self.max_len,
            }
        report["prefix_sharing"] = {
            "requested": bool(self.cfg.prefix_sharing),
            "enabled": self.prefix_sharing,
        }
        if self.prefix is not None:
            report["prefix_sharing"].update({
                "trie_nodes": len(self.prefix),
                "resident_prefix_tokens": self.prefix.resident_tokens(),
            })
        report["adaptive"] = {"enabled": self.adaptive is not None}
        if self.adaptive is not None:
            report["adaptive"].update({
                "warm_tier": self._warm_tier,
                "warm_pages_now": (self.allocator.warm_count()
                                   if self.paged else 0),
                **{k: self.stats[k] for k in (
                    "warm_retained", "warm_reclaimed", "warm_hits",
                    "warm_tokens_saved", "replans")},
                **self.adaptive.report(),
            })
        alloc = self.allocator if self.paged else None
        report["lifecycle"] = {
            "preemption_enabled": self.preemption,
            "max_queue": self.max_queue,
            "preempted": self.stats["preempted"],
            "preempted_forced": self.stats["preempted_forced"],
            "recompute_tokens": self.stats["recompute_tokens"],
            "cancelled": self.stats["cancelled"],
            "expired": self.stats["expired"],
            "rejected": self.stats["rejected"],
            "goodput_under_deadline": self._goodput(),
            "chaos": {
                "alloc_fail_p": self.cfg.chaos_alloc_fail_p,
                "preempt_p": self.cfg.chaos_preempt_p,
                "share_fail_p": self.cfg.chaos_share_fail_p,
                "corrupt_p": self.cfg.chaos_corrupt_p,
                "crash_after_wave": self.cfg.chaos_crash_after_wave,
                "seed": self.cfg.chaos_seed,
                "injected_alloc_failures": (
                    alloc.injected_failures
                    if isinstance(alloc, ChaosAllocator) else 0),
                "injected_share_failures": (
                    alloc.injected_share_failures
                    if isinstance(alloc, ChaosAllocator) else 0),
                "injected_corruptions": self.stats["injected_corruptions"],
            },
        }
        report["integrity"] = {
            "enabled": self.integrity,
            "strict_invariants": self._strict,
            "journal": self.journal_path is not None,
            "stamped_pages": len(self._stamped),
            "quarantined_pages": (len(alloc.quarantined_pages)
                                  + len(alloc.doomed_pages)
                                  if alloc is not None else 0),
            "corrupted_pages": self.stats["corrupted_pages"],
            "healed_requests": self.stats["healed_requests"],
            "snapshots": self.stats["snapshots"],
            "restores": self.stats["restores"],
        }
        if self.decode_plan is not None:
            report["decode_attention"] = {
                "assignment": {
                    k: v.value for k, v in self.decode_plan.assignment.items()
                },
                "vmem_bytes": self.decode_plan.vmem_bytes,
                "grid_order": list(self.decode_plan.grid_order),
                # The decode-step route the model was built with, and the
                # split count baked from decode_plan (the kernels' grid
                # parallelism when not "xla").
                "kernel": self.cfg.decode_kernel,
                "planned_splits": self.decode_splits,
                "kernel_bkv": (self.page_size if self.paged
                               else min(512, self.max_len)),
            }
        return report

    # -- requests ------------------------------------------------------------

    def _positions_needed(self, r: Request) -> int:
        """Prompt plus every decoded token but the last (never written)."""
        return len(r.prompt) + r.max_new_tokens - 1

    def _pages_needed(self, r: Request) -> int:
        return -(-self._positions_needed(r) // self.page_size)

    def _effective_prompt(self, r: Request) -> np.ndarray:
        """What admission prefills: the prompt, plus every token a preempted
        request already emitted (the last one's logits sample the restored
        stream's next token).  Its worst-case positions equal the
        original's, so page demand needs no restore case."""
        if not r.generated:
            return np.asarray(r.prompt, np.int32)
        return np.concatenate([np.asarray(r.prompt, np.int32),
                               np.asarray(r.generated, np.int32)])

    def _shared_prefix(self, eff: np.ndarray, chunks) -> tuple[list[int], int]:
        """(pages, tokens): the longest resident full-page prefix of ``eff``
        to attach to, capped below the prompt's full-page count so its last
        token is always re-prefilled (the logits seeding decode are
        computed, never assumed resident)."""
        pages = self.prefix.lookup(eff, chunks=chunks)
        pages = pages[:(len(eff) - 1) // self.page_size]
        return pages, len(pages) * self.page_size

    def _reject(self, reason: str, message: str, n: int = 1):
        self.stats["rejected"] += n
        raise AdmissionReject(reason, message)

    def submit(self, requests: list[Request]) -> None:
        """Validate the whole batch, then enqueue it (all or nothing)."""
        ids = set()
        for r in requests:
            if r.max_new_tokens < 1:
                self._reject("zero_budget", (
                    f"max_new_tokens must be >= 1, got {r.max_new_tokens} "
                    "(prefill emits the first token at admission)"))
            if len(r.prompt) == 0:
                self._reject("empty_prompt", (
                    "empty prompt: seg_lens == 0 marks a parked slot"))
            need = self._positions_needed(r)
            if need > self.max_len:
                self._reject("max_len", (
                    f"request needs {need} cache positions, "
                    f"max_len={self.max_len}"))
            if (self.paged
                    and self._pages_needed(r) > self.allocator.usable_pages()):
                self._reject("pool_too_small", (
                    f"request needs {self._pages_needed(r)} pages, pool has "
                    f"{self.allocator.usable_pages()}: it could never be "
                    "admitted and would block the FIFO queue forever"))
            if r.id is not None:
                prev = self._by_id.get(r.id)
                if (prev is not None and prev is not r) or r.id in ids:
                    self._reject("duplicate_id", (
                        f"request id {r.id!r} already submitted"))
                ids.add(r.id)
        if (self.max_queue is not None
                and len(self.queue) + len(requests) > self.max_queue):
            self._reject("queue_full", (
                f"submitting {len(requests)} request(s) would exceed "
                f"max_queue={self.max_queue} ({len(self.queue)} queued)"),
                n=len(requests))
        now = time.perf_counter()
        for r in requests:
            if r.id is None:
                r.id = f"req-{self._next_id}"
                self._next_id += 1
            self._by_id[r.id] = r
            r.submit_t = now
            r.status = "queued"
            self.queue.append(r)
            if self.journal is not None and not self._replaying:
                self.journal.append(snap.submit_event(r))
        if self.journal is not None and not self._replaying:
            # One fsync a submitted batch: an accepted request is durable
            # before the caller regains control.
            self.journal.flush()

    def cancel(self, request_id: str) -> bool:
        """Ask for a queued or resident request to be cancelled at the next
        lifecycle sweep (a chunk boundary); ``generated`` keeps what was
        emitted.  False for unknown or already-terminal ids."""
        r = self._by_id.get(request_id)
        if r is None or r.done:
            return False
        r.cancel_requested = True
        return True

    def request(self, request_id: str) -> Request | None:
        """The live handle of a submitted request id (terminal ones kept)."""
        return self._by_id.get(request_id)

    def results(self) -> dict[str, list[int]]:
        """Emitted tokens per request id."""
        return {rid: list(r.generated) for rid, r in self._by_id.items()}

    def serve_stats(self) -> dict:
        out = dict(self.stats)
        total = out["decode_tokens"] + out["prefill_tokens"]
        out["host_syncs_per_token"] = out["host_syncs"] / total if total else 0.0
        out["spec_acceptance_rate"] = (
            out["draft_accepted"] / out["draft_proposed"]
            if out["draft_proposed"] else 0.0)
        # Tokens of draft/verify rounds only, over those rounds.
        out["spec_tokens_per_round"] = (
            out["spec_tokens"] / out["spec_rounds"]
            if out["spec_rounds"] else 0.0)
        # Over fresh admissions: a restore's re-attach is not a new hit.
        out["prefix_hit_rate"] = (
            out["prefix_hits_fresh"] / out["admitted_fresh"]
            if out["admitted_fresh"] else 0.0)
        out["goodput_under_deadline"] = self._goodput()
        return out

    def _goodput(self) -> float:
        """Fraction of deadlined requests that reached a terminal state
        within their deadline; 1.0 when no request carried one."""
        total = self.stats["deadline_total"]
        return self.stats["deadline_met"] / total if total else 1.0

    # -- device steps --------------------------------------------------------

    def _write_back(self, cache) -> None:
        """Copy a cache the model returned into the static one: the
        advanced cursors (a new tensor), and any other leaf the model did
        not write in place."""
        for (path, dst), (src_path, src) in zip(_leaves(self.cache),
                                                _leaves(cache), strict=True):
            if path != src_path:
                raise RuntimeError(f"the model returned a cache of another "
                                   f"layout: {src_path} where {path} was")
            if src is not dst:
                dst.copy_(src)

    def _sample(self, logits, seeds, tok_idx):
        """The sampler with per-row keys folded from (request seed, token
        index): a function of the request, never of its slot."""
        keys = (sample_keys(seeds, tok_idx) if self.sampler.needs_keys
                else None)
        return self.sampler(logits, keys)

    @torch.inference_mode()
    def _prefill(self, tokens, seg_lens, start_lens, new_remaining,
                 new_tok_idx, new_seeds, hist_toks=None):
        """Ragged admission prefill: set each admitted slot's cursor to its
        attach point (0, or the shared prefix's length), prefill the
        unshared suffix (seg_lens == 0 parks the others) and sample each
        admitted slot's first token on the device with the key of stream
        index ``new_tok_idx`` (0 for a fresh request, ``len(generated)``
        for a restored one, whose prefill ends on its last emitted token),
        then set the slot's seed and next index.  A speculative engine
        also seeds each admitted slot's history with ``hist_toks``, its
        FULL effective prompt (shared prefix included, so an attached slot
        drafts what an unshared one drafts), then the first token.  Eager,
        and in place into the static buffers."""
        admitted = seg_lens > 0
        self.model.reset_slots(self.cache, admitted)
        lengths = self.cache["lengths"]
        lengths.copy_(torch.where(admitted, start_lens, lengths))
        logits, cache = self.model.prefill(
            self.params, self.cache, tokens, seg_lens=seg_lens)
        self._write_back(cache)
        nxt = self._sample(logits, new_seeds, new_tok_idx)
        self.cur_tok.copy_(torch.where(admitted, nxt, self.cur_tok))
        self.remaining.copy_(torch.where(admitted, new_remaining,
                                         self.remaining))
        self.seeds.copy_(torch.where(admitted, new_seeds, self.seeds))
        self.tok_idx.copy_(torch.where(admitted, new_tok_idx + 1,
                                       self.tok_idx))
        if self.spec:
            # Rows 0 .. full - 1 take the prompt, row full the first
            # token; past hist_len the proposer reads nothing, so the
            # previous occupant's tail needs no clearing.
            full = start_lens + seg_lens
            width = hist_toks.shape[1]
            cols = torch.arange(width, device=self.device)[None, :]
            write = admitted[:, None] & (cols < full[:, None])
            head = self.hist[:, :width]
            head.copy_(torch.where(write, hist_toks, head))
            at = full.long()[:, None]
            self.hist.scatter_(1, at, torch.where(
                admitted[:, None], nxt[:, None], self.hist.gather(1, at)))
            self.hist_len.copy_(torch.where(admitted, full + 1,
                                            self.hist_len))
        return nxt

    @torch.inference_mode()
    def _decode_chunk(self) -> None:
        """The chunk's body: ``chunk_size`` single-token steps for every
        slot, slots whose budget hits zero parking.  Reads and writes only
        the static buffers: the step's tokens and active flags go to
        ``_out``, and the cursors, tokens and budgets are copied back at
        the end.  A step of a parked slot changes nothing (its KV rows go
        to the sink, dt = 0 keeps its SSM state, its cursor advances by 0),
        so the body with every slot parked is a no-op on the state."""
        cache, tok, rem = self.cache, self.cur_tok, self.remaining
        tidx = self.tok_idx
        for i in range(self.chunk_size):
            active = rem > 0
            seg = active.to(torch.int32)
            logits, cache = self.model.decode_step(
                self.params, cache, tok[:, None], seg_lens=seg)
            tok = torch.where(active, self._sample(logits, self.seeds, tidx),
                              tok)
            tidx = tidx + seg
            rem = rem - seg
            self._out[0, i].copy_(tok)
            self._out[1, i].copy_(seg)
        self._write_back(cache)
        self.cur_tok.copy_(tok)
        self.remaining.copy_(rem)
        self.tok_idx.copy_(tidx)

    @torch.inference_mode()
    def _spec_chunk(self) -> None:
        """The speculative chunk's body: ``spec_rounds`` draft/verify/
        rollback rounds (the reference's ``_spec_chunk_fn``).  Each round,
        per active slot:

        1. *Draft*: ``ngram_propose`` mines the slot's history for
           ``spec_k`` tokens.
        2. *Verify*: one ragged ``prefill`` over ``[cur_tok, d_1..d_k]``
           (``seg_lens = k + 1``, 0 for parked slots) with every
           position's logits; the target at position j, sampled with the
           key of token index ``tok_idx + j``, is the token sequential
           decode would emit there, so targets are emissions.
        3. *Accept*: ``m = min(matching prefix + 1, remaining)``, 1..k + 1.
        4. *Rollback*: KV families set the cursor to base + m (the
           rejected rows past it are stale but masked, and rewritten
           before any read).  Recurrent families verify on a scratch
           copy of the SSM state and conv windows, so the live ones still
           hold the pre-verify state, and replay the block on them with
           ``seg_lens = m``.

        Rows the verify writes past a slot's mapped pages land on the sink
        page (table entry -1), past a ring's end on its sink row.  Reads
        and writes only static buffers; with every slot parked it changes
        no state (the rejected-row writes go to the history's sink
        column)."""
        b, k = self.slots, self.spec_k
        k1 = k + 1
        sink = self.hist.shape[1] - 1
        hist = self.hist[:, :sink]               # the proposer's (b, H) view
        cache, lengths = self.cache, self.cache["lengths"]
        # The verify advances the scratch's recurrent leaves in place and
        # leaves the live ones at the pre-verify state the replay starts
        # from; its KV rows go to the live pages.
        verify_cache = {**cache, **self._spec_scratch}
        tok, rem, hlen = self.cur_tok, self.remaining, self.hist_len
        tidx = self.tok_idx
        cols = torch.arange(k1, device=self.device)[None, :]
        row_seeds = self.seeds[:, None].expand(b, k1).reshape(-1)
        for j in range(self.spec_rounds):
            active = rem > 0
            drafts = ngram_propose(hist, hlen, self.spec_ngram, k)
            vt = torch.cat([tok[:, None], drafts], dim=1)         # (b, k1)
            seg_v = torch.where(active, k1, 0).to(torch.int32)
            for key, saved in self._spec_scratch.items():
                saved.copy_(cache[key])
            logits, _ = self.model.prefill(self.params, verify_cache, vt,
                                           seg_lens=seg_v, all_logits=True)
            targets = self._sample(logits.reshape(b * k1, -1), row_seeds,
                                   (tidx[:, None] + cols).reshape(-1)
                                   ).reshape(b, k1)
            match = (drafts == targets[:, :k]).to(torch.int32)
            accepted = torch.cumprod(match, dim=1).sum(dim=1)
            m = torch.where(active, torch.minimum(accepted + 1, rem),
                            0).to(torch.int32)
            # Usable drafts only: with rem tokens left a round can use at
            # most rem - 1 of them; matches past the budget count as
            # neither proposed nor accepted.
            usable = torch.where(active, torch.clamp(rem - 1, max=k), 0)
            acc_used = torch.clamp(m - 1, min=0)
            if self._spec_replay:
                self.model.prefill(self.params, cache, vt, seg_lens=m)
            lengths.add_(m)             # the model left the cursor at base
            emit = cols < m[:, None]                               # (b, k1)
            self.hist.scatter_(1, torch.where(emit, hlen[:, None] + cols,
                                              sink).long(), targets)
            last = targets.gather(1, (m - 1).clamp(0, k).long()[:, None])
            tok = torch.where(active, last[:, 0], tok)
            hlen = hlen + m
            tidx = tidx + m
            rem = rem - m
            out = self._spec_out[j]
            out[:, :k1].copy_(targets)
            out[:, k1:2 * k1].copy_(emit)
            out[:, 2 * k1].copy_(acc_used)
            out[:, 2 * k1 + 1].copy_(usable)
            out[:, 2 * k1 + 2].copy_(active)
        self.cur_tok.copy_(tok)
        self.remaining.copy_(rem)
        self.hist_len.copy_(hlen)
        self.tok_idx.copy_(tidx)

    def _chunk_body(self) -> None:
        """The chunk a replay (or the eager loop) runs: speculative rounds
        when ``spec_k > 0``, else plain single-token steps."""
        if self.spec:
            self._spec_chunk()
        else:
            self._decode_chunk()

    @torch.inference_mode()
    def _capture(self) -> None:
        """Capture the chunk's body as one CUDA graph, every slot parked.
        The warm-up on a side stream builds the kernels and sets their
        attributes at first use; its launches are real and counted.  The
        capture's counter ticks are kept as the delta each replay adds."""
        dev = self.device
        stream = torch.cuda.current_stream(dev)
        # The capture empties the allocator's cache first; so does this,
        # so that construction's freed blocks (a whisper engine's encoder
        # activations) do not count against the graph's pool.
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(stream)
        with torch.cuda.stream(side):
            self._chunk_body()
        stream.wait_stream(side)
        before = counters.snapshot()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            self._chunk_body()
        self._graph_delta = counters.delta(counters.snapshot(), before)
        counters.restore(before)       # the capture itself launched nothing
        self._graph = graph
        self.stats["captured_launches"] = counters.launches(self._graph_delta)
        self.stats["graph_pool_bytes"] = (torch.cuda.memory_reserved(dev)
                                          - reserved)

    def _static_ptrs(self) -> dict:
        """Address of every buffer a chunk reads or writes: the cache's
        leaves, the loop vectors (tokens, budgets, seeds, token indices),
        the output and the parameters; and for the speculative chunk the
        history, its length, its output and the recurrent scratch copy."""
        trees = {"cache": self.cache, "cur_tok": self.cur_tok,
                 "remaining": self.remaining, "seeds": self.seeds,
                 "tok_idx": self.tok_idx, "out": self._out,
                 "params": self.params}
        if self.spec:
            trees.update(hist=self.hist, hist_len=self.hist_len,
                         spec_out=self._spec_out,
                         spec_scratch=self._spec_scratch)
        return {path: t.data_ptr() for path, t in _leaves(trees)}

    def _check_static(self) -> None:
        """Raise if a buffer the chunk captured was rebound (a new tensor
        in its place) or the decode split count moved from the captured
        one: a graph replay would read and write the old buffers."""
        now = self._static_ptrs()
        if now != self._static:
            moved = sorted(str(p) for p in set(now) | set(self._static)
                           if now.get(p) != self._static.get(p))
            raise RuntimeError(
                f"ServeEngine: buffers of the captured decode chunk were "
                f"rebound: {moved[:8]}; write them in place")
        splits = (self.decode_splits, self.cfg.decode_splits)
        if splits != self._static_splits:
            raise RuntimeError(
                f"ServeEngine: decode splits {splits} differ from the "
                f"{self._static_splits} the chunk was captured with; a "
                "change that re-plans them must recapture")

    # -- host-side scheduling ------------------------------------------------

    def _live(self) -> list[tuple[int, Request]]:
        return [(i, r) for i, r in enumerate(self.slot_req) if r is not None]

    def _release_slot(self, r: Request) -> None:
        """Vacate ``r``'s slot host-side (finish, preempt, cancel, expire).
        Pages shared with live slots survive (refcount > 0); pages reaching
        zero return to the pool and their trie nodes evict.  The device
        page table is pushed at the next admission wave; until then the
        stale row is only read for a parked slot, which writes nothing and
        whose output is discarded."""
        slot = r.slot
        self.slot_req[slot] = None
        r.slot = -1
        if self.paged:
            freed = self.allocator.release(self._slot_pages[slot])
            if self._warm_tier and freed:
                # Trie-registered prefix pages may park warm instead of
                # freeing; what comes back must still be evicted.
                freed = self._maybe_retain(r, freed)
            if self.prefix is not None and freed:
                self.prefix.evict(freed)
            # A page leaving circulation (freed or quarantined) sheds its
            # stamp; its next holder stamps fresh bytes.  Pages sharers
            # still hold keep theirs: below every sharer's cursor they
            # never change.
            self._stamped.difference_update(freed)
            self._slot_pages[slot] = []
            self.page_table[slot] = -1
        self._dirty_slots.add(slot)

    def _maybe_retain(self, r: Request, freed: list[int]) -> list[int]:
        """Warm retention over pages that just reached refcount zero
        (DESIGN.md §5.7); returns the pages still to evict from the trie.
        Retention goes shallowest-first, within the deciding class's
        quota, and keeps a page only if its parent is held, warm or kept
        in this pass, so the warm set stays a depth-prefix of each chain;
        evicting a page whose descendants were retained earlier reclaims
        that warm subtree with it (no trie node outlives its parent)."""
        kept: set[int] = set()
        if r.adaptive_key is not None:
            deciding = r.adaptive_class or r.adaptive_key
            quota = self.adaptive.retain_quota(r.adaptive_key)
            for p in sorted(freed,
                            key=lambda q: (self.prefix.depth_of(q), q)):
                depth = self.prefix.depth_of(p)
                if depth <= 0:
                    continue          # tail or decode page: not in the trie
                if self.adaptive.class_warm_count(deciding) >= quota:
                    break             # the class's share is spent
                parent = self.prefix.parent_page(p)
                if depth > 1 and not (
                        parent in kept or self.allocator.is_warm(parent)
                        or self.allocator.ref_count(parent) > 0):
                    continue          # the chain is cut above: stay a prefix
                if self.allocator.retain(p):
                    self.adaptive.note_retained(p, deciding)
                    self.stats["warm_retained"] += 1
                    kept.add(p)
        evict = [p for p in freed if p not in kept]
        # Descendants of an evicted page can only be warm (a held child
        # implies a held parent) or in this same batch.
        extra: list[int] = []
        for p in evict:
            for q in self.prefix.subtree_pages(p):
                if q != p and self.allocator.is_warm(q) and q not in extra:
                    extra.append(q)
        if extra:
            self.allocator.reclaim(extra)
            self.adaptive.note_reclaimed(extra)
            self.stats["warm_reclaimed"] += len(extra)
        return evict + extra

    def _reclaim_warm(self, n_needed: int, protect: set[int]) -> int:
        """Return up to ``n_needed`` warm pages to the free list so a
        short admission can allocate (reclaim before preempt), in the
        policy's reclaim order, each with its warm subtree.  ``protect``
        (the chain the admission is about to revive) is never taken.
        Capacity always wins over retention."""
        taken: list[int] = []
        warm = sorted(self.allocator.warm_pages)
        for p in self.adaptive.reclaim_order(warm):
            if len(taken) >= n_needed:
                break
            if p in protect or p in taken:
                continue
            sub = [q for q in self.prefix.subtree_pages(p) if q not in taken]
            if any(q in protect for q in sub):
                continue
            taken.extend(sub)
        if taken:
            self.prefix.evict(taken)
            self._stamped.difference_update(taken)
            self.allocator.reclaim(taken)
            self.adaptive.note_reclaimed(taken)
            self.stats["warm_reclaimed"] += len(taken)
        return len(taken)

    def _retire(self, r: Request, status: str) -> None:
        """Terminal transition for a non-finish exit (cancelled/expired)."""
        r.status = status
        r.done = True
        r.cancel_requested = False
        self.stats[status] += 1
        if r.deadline_s is not None:
            self.stats["deadline_total"] += 1
        if self.journal is not None and not self._replaying:
            self.journal.append(snap.terminal_event(r))

    def _finish(self, r: Request) -> None:
        r.done = True
        r.status = "finished"
        if self.journal is not None and not self._replaying:
            self.journal.append(snap.terminal_event(r))
        if r.deadline_s is not None:
            self.stats["deadline_total"] += 1
            if time.perf_counter() - r.submit_t <= r.deadline_s:
                self.stats["deadline_met"] += 1
        slot = r.slot
        self._release_slot(r)
        # The device budget already hit zero: no zeroing needed.
        self._dirty_slots.discard(slot)

    def _pick_victim(self, head: Request, wave_slots: set[int]
                     ) -> Request | None:
        """A never-preempted resident outside this wave, or None: the
        youngest, or under the adaptive policy the cheapest to recompute
        (``victim_cost``: replay tokens less a page's worth per page other
        slots still share), ties youngest-first.  A head that was itself
        preempted never preempts, so natural preemptions are bounded by
        the request count."""
        if not self.preemption or head.preempted_n > 0:
            return None
        cands = [r for i, r in enumerate(self.slot_req)
                 if r is not None and i not in wave_slots
                 and r.preempted_n == 0]
        if not cands:
            return None
        if self.adaptive is not None:
            return min(cands, key=lambda r: (
                self.adaptive.victim_cost(r, self.allocator,
                                          self._slot_pages[r.slot]),
                -r.admit_seq))
        return max(cands, key=lambda r: r.admit_seq)

    def _preempt(self, victim: Request, forced: bool = False) -> None:
        """Evict a resident mid-stream and re-enqueue it at the queue front
        (residents are older than anything queued) for a recompute
        restore over prompt + emitted tokens."""
        self._release_slot(victim)
        victim.status = "preempted"
        victim.preempted_n += 1
        self.queue.appendleft(victim)
        self.stats["preempted"] += 1
        if forced:
            self.stats["preempted_forced"] += 1

    def _chaos_forced_preempt(self) -> None:
        """With seeded probability cfg.chaos_preempt_p, force-preempt the
        youngest resident at a wave boundary."""
        if self._chaos_rng.random() >= self.cfg.chaos_preempt_p:
            return
        cands = [r for r in self.slot_req if r is not None]
        if cands:
            self._preempt(max(cands, key=lambda r: r.admit_seq), forced=True)

    def _deadline_hit(self, r: Request, now: float) -> bool:
        return r.deadline_s is not None and now - r.submit_t > r.deadline_s

    def _sweep_lifecycle(self) -> None:
        """Chunk-boundary sweep: retire cancelled and expired requests,
        queued or resident (a resident exit frees its slot and pages and
        keeps its partial ``generated``)."""
        now = time.perf_counter()
        if self.queue:
            keep = []
            for r in self.queue:
                if r.cancel_requested:
                    self._retire(r, "cancelled")
                elif self._deadline_hit(r, now) or (
                        r.max_queue_wait_s is not None
                        and now - r.submit_t > r.max_queue_wait_s):
                    self._retire(r, "expired")
                else:
                    keep.append(r)
            if len(keep) != len(self.queue):
                self.queue = collections.deque(keep)
        for _, r in self._live():
            if r.cancel_requested:
                self._release_slot(r)
                self._retire(r, "cancelled")
            elif self._deadline_hit(r, now):
                self._release_slot(r)
                self._retire(r, "expired")

    def _acquire_pages(self, head: Request, eff: np.ndarray,
                       wave_slots: set[int]):
        """The head's page table: shared resident prefix pages (a refcount
        bump) + freshly allocated private pages.  While the pool is short,
        preempt one victim per retry (each retry admits or removes a
        resident, so the loop ends).  The prefix lookup re-runs each try
        (a released victim can shrink the resident chain); alloc goes
        first and share only on success, and a refused share rolls the
        alloc back, so a gated head leaves every refcount untouched.  With
        the warm tier, a short pool first reclaims warm pages (never the
        head's own chain), and warm pages of the chain are revived
        (refcount 0 -> 1) rather than shared.
        Returns ``(table, chunks, shared_tokens)`` or ``(None, None, 0)``."""
        need = self._pages_needed(head)
        while True:
            shared, shared_len, chunks = [], 0, None
            if self.prefix is not None:
                chunks = self.prefix.chunks(eff)
                shared, shared_len = self._shared_prefix(eff, chunks)
            n_fresh = need - len(shared)
            if self._warm_tier:
                short = n_fresh - self.allocator.free_count()
                if short > 0 and self.allocator.warm_count():
                    self._reclaim_warm(short, protect=set(shared))
            ids = self.allocator.alloc(n_fresh)
            if ids is not None:
                warm = ({p for p in shared if self.allocator.is_warm(p)}
                        if self._warm_tier else set())
                held = [p for p in shared if p not in warm]
                if not held or self.allocator.share(held):
                    if warm:
                        revived = [p for p in shared if p in warm]
                        self.allocator.revive(revived)
                        self.adaptive.note_revived(revived)
                        self.stats["warm_hits"] += 1
                        self.stats["warm_tokens_saved"] += (
                            len(revived) * self.page_size)
                    return shared + ids, chunks, shared_len
                # Refused share: roll the alloc back (warm pages were not
                # revived yet).
                self.allocator.release(ids)
            victim = self._pick_victim(head, wave_slots)
            if victim is None:
                return None, None, 0
            self._preempt(victim)

    def _admit_wave(self) -> None:
        if self._chaos_rng is not None:
            self._chaos_forced_preempt()
        if self.adaptive is not None:
            self.adaptive.begin_wave()
        # Entries carry the EFFECTIVE prompt (prompt + emitted tokens for a
        # request being restored): downstream it is the prompt.
        wave: list[tuple[int, Request, np.ndarray]] = []
        wave_slots: set[int] = set()
        now = time.perf_counter()
        while self.queue:
            slot = next(
                (i for i, q in enumerate(self.slot_req) if q is None), None)
            if slot is None:
                break
            # Pop before any preemption: victims re-enter at the front.
            head = self.queue.popleft()
            eff = self._effective_prompt(head)
            head.prefix_tokens = 0
            if self.paged:
                table, chunks, shared_len = self._acquire_pages(
                    head, eff, wave_slots)
                if table is None:         # FIFO head-of-line gate
                    self.queue.appendleft(head)
                    break
                head.prefix_tokens = shared_len
                self._slot_pages[slot] = table
                self.page_table[slot] = -1
                self.page_table[slot, :len(table)] = table
                if self.prefix is not None:
                    # Index this prompt's own full pages; resident chunks
                    # keep their (shared) nodes.
                    self.prefix.register(eff, table[:len(chunks)],
                                         chunks=chunks)
                    if self.adaptive is not None:
                        self._classify(head, eff, chunks, table)
                    if shared_len:
                        self.stats["prefix_hits"] += 1
                        if not head.generated:
                            self.stats["prefix_hits_fresh"] += 1
                        self.stats["prefix_pages_shared"] += (
                            shared_len // self.page_size)
                        self.stats["prefix_tokens_shared"] += shared_len
            head.admit_t = now
            if head.queue_wait_s is None:
                head.queue_wait_s = now - head.submit_t
            head.status = "resident"
            head.slot = slot
            head.admit_seq = self._admit_seq
            self._admit_seq += 1
            self.slot_req[slot] = head
            if head.generated:
                self.stats["readmitted"] += 1
                self.stats["recompute_tokens"] += len(head.generated)
            else:
                self.stats["admitted_fresh"] += 1
            wave.append((slot, head, eff))
            wave_slots.add(slot)
        # Park slots vacated mid-stream that this wave did not refill.
        stale = sorted(self._dirty_slots - wave_slots)
        self._dirty_slots.clear()
        dev = self.device
        if stale:
            with torch.inference_mode():
                self.remaining.index_fill_(
                    0, torch.tensor(stale, device=dev), 0)
        if not wave:
            if self._chaos or self._strict:
                self.check_invariants()
            return
        # Attached slots prefill only their suffix, so the pad bucket is
        # the widest suffix in the wave.
        pad = _pad_bucket(max(len(eff) - r.prefix_tokens
                              for _, r, eff in wave), self.max_len)
        toks = np.zeros((self.slots, pad), np.int32)
        # A speculative engine's history takes the full effective prompt.
        htoks = (np.zeros((self.slots, _pad_bucket(
            max(len(eff) for _, _, eff in wave), self.max_len)), np.int32)
            if self.spec else None)
        seg = np.zeros((self.slots,), np.int32)
        start = np.zeros((self.slots,), np.int32)
        new_rem = np.zeros((self.slots,), np.int32)
        new_tidx = np.zeros((self.slots,), np.int32)
        new_seeds = np.zeros((self.slots,), np.int32)
        for slot, r, eff in wave:
            n = len(eff) - r.prefix_tokens
            self.stats["prefill_work_tokens"] += n
            toks[slot, :n] = eff[r.prefix_tokens:]
            if self.spec:
                htoks[slot, :len(eff)] = eff
            seg[slot] = n
            start[slot] = r.prefix_tokens     # page-aligned attach cursor
            new_rem[slot] = r.max_new_tokens - len(r.generated) - 1
            # A restored request samples from stream index len(generated):
            # its prefill ends on its last emitted token.
            new_tidx[slot] = len(r.generated)
            # Any Python int (64-bit hashes, negatives) folds into the
            # int32 range, still a function of the request's seed alone.
            new_seeds[slot] = (0 if r.seed is None else r.seed) % (2 ** 31)
        if self.paged:                 # the whole table, -1 entries too
            with torch.inference_mode():
                self.cache["pages"].copy_(torch.from_numpy(self.page_table))
        # Admission consults the policy engine: the (PlanCache-memoized)
        # decode-attention plan.
        self.decode_plan = self._plan_decode()
        nxt = self._prefill(torch.from_numpy(toks).to(dev),
                            torch.from_numpy(seg).to(dev),
                            torch.from_numpy(start).to(dev),
                            torch.from_numpy(new_rem).to(dev),
                            torch.from_numpy(new_tidx).to(dev),
                            torch.from_numpy(new_seeds).to(dev),
                            None if htoks is None
                            else torch.from_numpy(htoks).to(dev))
        first = nxt.cpu().numpy()                  # host sync: 1 per wave
        self.stats["host_syncs"] += 1
        self.stats["admission_waves"] += 1
        if (self.adaptive is not None and self.adaptive.pinned is None
                and self.stats["admission_waves"]
                % self.adaptive.replan_every == 0):
            # Re-plan boundary: the counters through the serve-policy
            # lattice, per class.  Placement only.
            self.adaptive.replan(self.stats)
            self.stats["replans"] += 1
        if self.paged:
            self.stats["peak_pages_held"] = max(
                self.stats["peak_pages_held"],
                self.n_pages - self.allocator.free_count())
        now = time.perf_counter()
        for slot, r, _ in wave:
            r.generated.append(int(first[slot]))
            self.stats["prefill_tokens"] += 1
            if r.ttft_s is None:
                r.ttft_s = now - r.admit_t
            if len(r.generated) >= r.max_new_tokens:
                self._finish(r)
        if self._chaos or self._strict:
            self.check_invariants()

    def _classify(self, head: Request, eff: np.ndarray, chunks,
                  table: list[int]) -> None:
        """Key the head's workload class by its first full page, feed a
        fresh admission to the policy's counters (which names the class
        deciding its retention; a readmission keeps the one it had, since
        its grown prompt would re-classify) and touch its pages."""
        key = self.adaptive.class_key(chunks)
        head.adaptive_key = key
        if head.generated:
            head.adaptive_class = head.adaptive_class or key
        else:
            head.adaptive_class = self.adaptive.note_arrival(
                key, len(eff),
                ((len(eff) - 1) // self.page_size) * self.page_size)
        self.adaptive.touch(table)

    def _run_chunk(self) -> None:
        self._check_static()
        if self._graph is not None:
            self._graph.replay()
            counters.advance(self._graph_delta)
            self.stats["graph_replays"] += 1
        else:
            self._chunk_body()
        if self.spec:
            self._collect_spec()
            return
        out = self._out.cpu().numpy()              # host sync: 1 per chunk
        toks, actives = out[0], out[1]
        self.stats["host_syncs"] += 1
        self.stats["chunks"] += 1
        for slot, r in self._live():
            emitted = np.nonzero(actives[:, slot])[0]
            r.generated.extend(int(t) for t in toks[emitted, slot])
            self.stats["decode_tokens"] += len(emitted)
            if len(r.generated) >= r.max_new_tokens:
                self._finish(r)

    def _collect_spec(self) -> None:
        """Read a speculative chunk's output (one device-to-host copy):
        per round and live slot, the emitted targets and the reference's
        exact counters (rounds, usable drafts proposed and accepted,
        tokens)."""
        out = self._spec_out.cpu().numpy()         # host sync: 1 per chunk
        k1 = self.spec_k + 1
        self.stats["host_syncs"] += 1
        self.stats["chunks"] += 1
        for slot, r in self._live():
            for row in out[:, slot]:
                if not row[2 * k1 + 2]:
                    continue
                emitted = row[:k1][row[k1:2 * k1] != 0]
                r.generated.extend(int(t) for t in emitted)
                self.stats["decode_tokens"] += len(emitted)
                self.stats["spec_tokens"] += len(emitted)
                self.stats["spec_rounds"] += 1
                self.stats["draft_proposed"] += int(row[2 * k1 + 1])
                self.stats["draft_accepted"] += int(row[2 * k1])
            if len(r.generated) >= r.max_new_tokens:
                self._finish(r)

    def check_invariants(self) -> None:
        """Raise AssertionError unless engine, allocator and trie state are
        conserved: each resident request sits in exactly the slot that maps
        it and is neither queued nor terminal; the allocator's held pages
        are exactly the union of resident slots' pages, with refcounts
        equal to the number of slots mapping each; free + held + warm +
        quarantined partitions the pool (no leaks), quarantined pages stay
        out of circulation and doomed ones held; the warm tier keeps
        within its budget and inside the trie; every trie page and every
        integrity stamp is held or warm.  Identity (never ``==``) is used
        for request membership."""
        self.stats["invariant_checks"] += 1

        def check(ok, message):
            if not ok:
                raise AssertionError(message)

        queued = list(self.queue)
        for slot, r in enumerate(self.slot_req):
            if r is None:
                continue
            check(r.slot == slot, f"slot {slot} maps request at {r.slot}")
            check(not r.done and r.status == "resident",
                  f"slot {slot} holds a {r.status!r} request")
            check(not any(q is r for q in queued),
                  f"request {r.id!r} is both resident and queued")
            check(len(r.generated) < r.max_new_tokens,
                  f"resident request {r.id!r} has exhausted its budget")
        for q in queued:
            check(not q.done and q.status in ("queued", "preempted"),
                  f"queued request {q.id!r} has status {q.status!r}")
        if not self.paged:
            return
        slot_refs: collections.Counter[int] = collections.Counter()
        for slot in range(self.slots):
            pages = self._slot_pages[slot]
            row = self.page_table[slot]
            if self.slot_req[slot] is None:
                check(pages == [], f"vacant slot {slot} leaks pages {pages}")
                check((row == -1).all(), f"vacant slot {slot} maps {row}")
                continue
            check(len(pages) == len(set(pages)),
                  f"slot {slot} maps a page twice: {pages}")
            check(list(row[:len(pages)]) == pages,
                  f"page-table drift in slot {slot}")
            check((row[len(pages):] == -1).all(),
                  f"slot {slot} maps pages past its table")
            slot_refs.update(pages)
        held = self.allocator.held_pages
        check(held == set(slot_refs),
              f"held/mapped drift: leaked={sorted(held - set(slot_refs))} "
              f"phantom={sorted(set(slot_refs) - held)}")
        for page, refs in slot_refs.items():
            check(self.allocator.ref_count(page) == refs,
                  f"page {page}: allocator refcount "
                  f"{self.allocator.ref_count(page)} != {refs} mapping slots")
        free = self.allocator.free_pages
        quar = self.allocator.quarantined_pages
        warm = self.allocator.warm_pages
        check(not quar & held and not quar & set(free),
              f"quarantined pages back in circulation: "
              f"{sorted(quar & (held | set(free)))}")
        check(self.allocator.doomed_pages <= held,
              "doomed (pending-quarantine) pages must still be held")
        parts = free + sorted(held) + sorted(warm) + sorted(quar)
        check(sorted(parts) == list(range(self.n_pages)),
              "free + held + warm + quarantined is not a partition of the "
              "pool")
        check(len(warm) <= self.allocator.warm_budget,
              f"warm tier over budget: {len(warm)} > "
              f"{self.allocator.warm_budget}")
        check(not self._stamped - held - warm,
              f"integrity stamps outlive their pages: "
              f"{sorted(self._stamped - held - warm)}")
        if self.prefix is not None:
            resident = self.prefix.resident_pages()
            stray = resident - held - warm
            check(not stray, f"trie nodes outlive their pages: {stray}")
            check(warm <= resident, f"warm pages outside the trie: "
                                    f"{sorted(warm - resident)}")
        else:
            check(not warm, f"warm pages without a prefix index: {warm}")

    # -- KV page integrity (DESIGN.md §5.6) ----------------------------------

    def _pool_leaves(self) -> list[torch.Tensor]:
        """The paged K/V pool leaves: the K and V of the cache's self-KV
        subtree (the model's ``kv_pool`` path), whose trailing axes are
        (n_pages + 1, page_size, heads, head_dim), the sink page last.
        Chosen by the cache's structure, never by shape: a cross K/V leaf
        (slots, src_len, heads, head_dim) can have the pool's shape."""
        pool = self.cache
        for key in self.model.kv_pool:
            pool = pool[key]
        return [pool["k"], pool["v"]]

    @torch.inference_mode()
    def _fingerprint_pool(self) -> torch.Tensor:
        """Every page's fingerprint, on the device: (n_pages + 1, 8 x pool
        leaves) int64.  Each leaf's bytes, a page of a layer to a row, go
        through one int8 GEMM with ``_fp_mult`` (exact int32 sums), summed
        over the leading stack axes.  The reference CRC32s pages pulled to
        the host; these values differ, but they change whenever a word of
        the page does, which is what stamping and verifying need."""
        sums = []
        for leaf in self._pool_leaves():
            rows = leaf.view(torch.int8).reshape(-1, self._fp_mult.shape[0])
            part = torch._int_mm(rows, self._fp_mult)
            sums.append(part.view(-1, self.n_pages + 1, 8).sum(
                dim=0, dtype=torch.int64))
        return torch.cat(sums, dim=1)

    def _sealed_pages(self) -> set[int]:
        """Pages wholly below some resident slot's host-computed write
        cursor (len(prompt) + len(generated) - 1).  Sealed content is
        immutable: a slot's cursor only grows during its residency (a
        speculative rollback rewinds within the round, never below a chunk
        boundary), and shared pages sit below every sharer's cursor."""
        sealed: set[int] = set()
        for slot, r in self._live():
            cur = len(r.prompt) + len(r.generated) - 1
            sealed.update(self._slot_pages[slot][:cur // self.page_size])
        return sealed

    @torch.inference_mode()
    def _corrupt_page(self, page: int) -> None:
        """Chaos flip: add 1 to element [..., page, 0, 0, 0] of the first
        pool leaf (every layer's), in place on the device, as real memory
        corruption would land."""
        self._pool_leaves()[0][..., page, 0, 0, 0] += 1

    def _integrity_sweep(self) -> list[int]:
        """Chunk-boundary pass: stamp newly sealed pages, land any injected
        corruption (chaos_corrupt_p), then verify every stamp.  Corruption
        lands after stamping and before verification, so a flipped page is
        found and healed before any later chunk reads it.  One
        device-to-host copy (the verify's), the reference's one pull."""
        self.stats["integrity_sweeps"] += 1
        fp = self._fingerprint_pool()
        new = sorted(self._sealed_pages() - self._stamped)
        if new:
            idx = torch.tensor(new, device=self.device)
            with torch.inference_mode():
                self._fp_stamp.index_copy_(0, idx, fp.index_select(0, idx))
            self._stamped.update(new)
        if (self._corrupt_rng is not None and self._stamped
                and self._corrupt_rng.random() < self.cfg.chaos_corrupt_p):
            stamped = sorted(self._stamped)
            self._corrupt_page(
                stamped[int(self._corrupt_rng.integers(len(stamped)))])
            self.stats["injected_corruptions"] += 1
            fp = self._fingerprint_pool()     # the pool's bytes changed
        return self._verify(fp)

    def verify_pages(self) -> list[int]:
        """Re-fingerprint every stamped page; quarantine mismatches and
        heal their slots by recompute restore (DESIGN.md §5.6).  Returns
        the corrupted page ids."""
        if not self.paged or not self._stamped:
            return []
        return self._verify(self._fingerprint_pool())

    def _verify(self, fp: torch.Tensor) -> list[int]:
        """Hold the stamps against ``fp`` (one device-to-host copy of a
        flag a page).  A corrupted page is quarantined in the allocator (a
        held one is doomed: it leaves circulation at its last release),
        then every slot mapping it is preempted, so re-admission recomputes
        its KV into healthy pages, oldest first back at the queue front.  A
        corrupted warm page has no sharers: its warm subtree leaves the
        trie, clean pages to the free list, corrupted ones to quarantine."""
        with torch.inference_mode():
            differs = (fp != self._fp_stamp).any(dim=1).cpu().numpy()
        self.stats["host_syncs"] += 1
        bad = sorted(p for p in self._stamped if differs[p])
        if not bad:
            return []
        badset = set(bad)
        for p in bad:
            if p not in self._stamped:
                continue          # handled with a warm subtree above it
            if self._warm_tier and self.allocator.is_warm(p):
                sub = self.prefix.subtree_pages(p)
                self.prefix.evict(sub)
                self._stamped.difference_update(sub)
                clean = [q for q in sub if q not in badset]
                for q in sub:
                    if q in badset:
                        self.stats["corrupted_pages"] += 1
                        self.allocator.quarantine(q)
                if clean:
                    self.allocator.reclaim(clean)
                    self.stats["warm_reclaimed"] += len(clean)
                self.adaptive.note_reclaimed(sub)
                continue
            self._stamped.discard(p)
            self.stats["corrupted_pages"] += 1
            self.allocator.quarantine(p)
        victims = [r for slot, r in self._live()
                   if badset & set(self._slot_pages[slot])]
        # Healing is exempt from the once-only victim guard: a slot that
        # reads poisoned KV is restored whatever its preemption history.
        for r in sorted(victims, key=lambda r: r.admit_seq, reverse=True):
            self.stats["healed_requests"] += 1
            self._preempt(r)
        if self._chaos or self._strict:
            self.check_invariants()
        return bad

    # -- snapshot / restore (DESIGN.md §5.6) ---------------------------------

    def _geometry(self) -> dict:
        return {"slots": self.slots, "max_len": self.max_len,
                "paged": self.paged,
                "page_size": self.page_size if self.paged else None,
                "n_pages": self.n_pages if self.paged else None}

    def snapshot(self, path: str) -> dict:
        """Write host-side truth to ``path`` (atomic, checksummed), in the
        reference's format.  Nothing on the device is saved: every KV byte
        is recomputable from (prompt, emitted tokens, seed, token index),
        so in-flight requests are recorded as re-queueable work and
        terminal ones keep their streams.  The journal offset recorded
        here is where replay resumes after an unplanned kill.  Call it
        between steps (chunk boundaries), where host state is consistent."""
        self.stats["snapshots"] += 1
        residents = sorted((r for _, r in self._live()),
                           key=lambda r: r.admit_seq)
        queued = list(self.queue)
        terminal = [r for r in self._by_id.values() if r.done]
        # Residents re-enter as "preempted": re-queued work with tokens
        # already emitted; the crash does not spend their preemption guard.
        records = ([snap.request_record(r) for r in terminal]
                   + [snap.request_record(r, status="preempted")
                      for r in residents]
                   + [snap.request_record(r) for r in queued])
        alloc = None
        if self.paged:
            alloc = {
                "refcounts": {str(p): self.allocator.ref_count(p)
                              for p in sorted(self.allocator.held_pages)},
                "quarantined": sorted(self.allocator.quarantined_pages),
                "doomed": sorted(self.allocator.doomed_pages),
                "page_tables": {str(slot): list(self._slot_pages[slot])
                                for slot in range(self.slots)
                                if self._slot_pages[slot]},
            }
        payload = {
            "cfg": snap.cfg_fingerprint(self.cfg),
            "geometry": self._geometry(),
            "counters": {"next_id": self._next_id,
                         "admit_seq": self._admit_seq},
            "stats": dict(self.stats),
            # Learned adaptive class state survives a restore; warm pages
            # do not (their KV died with the process).
            "adaptive": (self.adaptive.snapshot_state()
                         if self.adaptive is not None else None),
            "requests": records,
            "allocator": alloc,
            "journal": {"path": self.journal_path,
                        "offset": (self.journal.offset()
                                   if self.journal is not None else 0)},
        }
        snap.write_snapshot(path, payload)
        return {"path": path, "requests": len(records),
                "in_flight": len(residents) + len(queued)}

    @staticmethod
    def _audit_snapshot(payload: dict) -> None:
        """Raise unless the snapshot's refcounts equal the number of page
        tables mapping each page: one that disagrees was written corrupt
        and must not restore."""
        alloc = payload.get("allocator")
        if not alloc:
            return
        mapped: collections.Counter[int] = collections.Counter()
        for pages in alloc["page_tables"].values():
            mapped.update(pages)
        refs = {int(p): n for p, n in alloc["refcounts"].items()}
        if refs != dict(mapped):
            raise SnapshotError("inconsistent", (
                "snapshot refcounts disagree with its page tables: "
                f"refcounts={refs} mapped={dict(mapped)}"))

    @staticmethod
    def _request_from_record(rec: dict, now: float) -> Request:
        r = Request(prompt=np.asarray(rec["prompt"], np.int32),
                    max_new_tokens=rec["max_new_tokens"], seed=rec["seed"],
                    id=rec["id"], deadline_s=rec["deadline_s"],
                    max_queue_wait_s=rec["max_queue_wait_s"])
        r.generated = list(rec["generated"])
        r.status = rec["status"]
        r.preempted_n = rec["preempted_n"]
        r.cancel_requested = rec["cancel_requested"]
        r.ttft_s = rec["ttft_s"]
        r.queue_wait_s = rec["queue_wait_s"]
        r.done = rec["status"] in ("finished", "cancelled", "expired")
        if not r.done:
            # SLO clocks restart at recovery: time spent dead is not
            # charged to the request's deadline.
            r.submit_t = now
        return r

    @torch.inference_mode()
    def _hard_reset(self) -> None:
        """Return every piece of state to the just-constructed blank: the
        device buffers in place (the cache's leaves zeroed, its page table
        unmapped, the loop vectors, outputs and history zeroed), so the
        captured chunk and the rebinding guard stay valid; and on the host
        the slots, queue, allocator, trie, stamps, adaptive state and run
        counters (the capture's own fields are the engine's and stay)."""
        for path, leaf in _leaves(self.cache):
            if path == ("pages",):
                leaf.fill_(-1)
            else:
                leaf.zero_()
        if self.model.fill_source is not None:
            # The fixed-source leaves (cross K/V, the encoder's states or
            # the projected vision tokens) recomputed into their buffers.
            self.model.fill_source(self.params, self.cache, **self.extras)
        bufs = [self.cur_tok, self.remaining, self.seeds, self.tok_idx,
                self._out]
        if self.spec:
            bufs += [self.hist, self.hist_len, self._spec_out]
        for t in bufs:
            t.zero_()
        b = self.slots
        self.slot_req = [None] * b
        self.queue = collections.deque()
        self._by_id = {}
        self._next_id = 0
        self._admit_seq = 0
        self._dirty_slots = set()
        self._stamped = set()
        if self.paged:
            self.allocator = self._make_allocator()
            self.page_table = np.full((b, self.pages_per_slot), -1, np.int32)
            self._slot_pages = [[] for _ in range(b)]
            if self.prefix is not None:
                self.prefix = PrefixIndex(self.page_size)
        if self.adaptive is not None:
            a = self.adaptive
            self.adaptive = AdaptivePolicy(
                warm_pages=a.warm_pages, replan_every=a.replan_every,
                page_size=a.page_size, spec_k=a.spec_k, pinned=a.pinned)
        for k in self.stats:
            if k not in _ENGINE_STATS:
                self.stats[k] = 0

    def restore(self, path: str | None = None) -> dict:
        """Rebuild the engine from a snapshot and/or the request journal.

        Validates before discarding anything: a corrupt or mismatched
        snapshot raises a typed ``SnapshotError`` and leaves the live
        engine untouched.  Then resets (``_hard_reset``), re-installs the
        quarantine, re-enqueues every in-flight request (the snapshot's
        residents first, in admission order, then its queue) and replays
        the journal past the snapshot's offset: unknown submits re-enter
        the queue, journaled terminal events re-retire their requests with
        the tokens they had emitted.  ``path=None`` replays the whole
        journal.  Device KV is rebuilt by the ordinary recompute prefill,
        so the restored streams are the uninterrupted run's."""
        if path is None and self.journal_path is None:
            raise SnapshotError(
                "no_source", "restore() needs a snapshot path or a journal")
        payload = None
        if path is not None:
            payload = snap.load_snapshot(path)
            mine = snap.cfg_fingerprint(self.cfg)
            theirs = payload.get("cfg") or {}
            if theirs != mine:
                drift = sorted(k for k in set(mine) | set(theirs)
                               if mine.get(k) != theirs.get(k))
                raise SnapshotError("config_mismatch", (
                    f"snapshot was taken under a different config: {drift}"))
            if payload.get("geometry") != self._geometry():
                raise SnapshotError("geometry_mismatch", (
                    f"snapshot geometry {payload.get('geometry')} != "
                    f"engine geometry {self._geometry()}"))
            self._audit_snapshot(payload)
        self._hard_reset()
        now = time.perf_counter()
        restored = replayed = 0
        journal_offset = 0
        self._replaying = True
        try:
            if payload is not None:
                self._next_id = payload["counters"]["next_id"]
                self._admit_seq = payload["counters"]["admit_seq"]
                for k, v in payload["stats"].items():
                    if k in self.stats and k not in _ENGINE_STATS:
                        self.stats[k] = v
                if self.adaptive is not None and payload.get("adaptive"):
                    self.adaptive.restore_state(payload["adaptive"])
                alloc = payload.get("allocator")
                if self.paged and alloc:
                    # The holders of doomed pages died with the crash: they
                    # are quarantined outright.
                    for p in alloc["quarantined"] + alloc["doomed"]:
                        self.allocator.quarantine(p)
                for rec in payload["requests"]:
                    r = self._request_from_record(rec, now)
                    self._by_id[r.id] = r
                    if not r.done:
                        self.queue.append(r)
                        restored += 1
                journal_offset = (payload.get("journal") or {}).get(
                    "offset", 0)
            if (self.journal_path is not None
                    and os.path.exists(self.journal_path)):
                for ev in snap.RequestJournal.replay(self.journal_path,
                                                     journal_offset):
                    replayed += 1
                    if ev.get("ev") == "submit":
                        if ev["id"] in self._by_id:
                            continue
                        r = Request(prompt=np.asarray(ev["prompt"], np.int32),
                                    max_new_tokens=ev["max_new_tokens"],
                                    seed=ev["seed"], id=ev["id"],
                                    deadline_s=ev["deadline_s"],
                                    max_queue_wait_s=ev["max_queue_wait_s"])
                        r.status = "queued"
                        r.submit_t = now
                        self._by_id[r.id] = r
                        self.queue.append(r)
                        restored += 1
                    elif ev.get("ev") == "terminal":
                        r = self._by_id.get(ev["id"])
                        if r is None:
                            continue
                        if not r.done and any(q is r for q in self.queue):
                            self.queue = collections.deque(
                                q for q in self.queue if q is not r)
                            restored -= 1
                        r.generated = list(ev["generated"])
                        r.status = ev["status"]
                        r.done = True
        finally:
            self._replaying = False
        self.stats["restores"] += 1
        if self._chaos or self._strict:
            self.check_invariants()
        return {"restored": restored, "replayed_events": replayed,
                "terminal": sum(1 for r in self._by_id.values() if r.done)}

    # -- scheduler loop ------------------------------------------------------

    def step(self) -> bool:
        """One scheduler tick: lifecycle sweep (cancel/expire), admission
        (with preemption), one decode chunk if anything is resident, then
        the integrity sweep and a journal flush, so every step ends on a
        durable, verified chunk boundary.  Returns True while work
        remains."""
        self._sweep_lifecycle()
        self._admit_wave()
        if any(r is not None for r in self.slot_req):
            self._run_chunk()
        if self.integrity:
            self._integrity_sweep()
        if self.journal is not None:
            self.journal.flush()
        if (self.cfg.chaos_crash_after_wave > 0
                and self.stats["admission_waves"]
                >= self.cfg.chaos_crash_after_wave):
            # Injected kill (DESIGN.md §5.6): the journal is flushed and the
            # host state sits at a chunk boundary, what a kill between
            # steps leaves on disk; recovery restores a fresh engine.
            raise ChaosCrash(self.stats["admission_waves"])
        return bool(self.queue) or any(r is not None for r in self.slot_req)

    def _progress_marker(self) -> tuple:
        s = self.stats
        return (s["decode_tokens"], s["prefill_tokens"], s["preempted"],
                s["cancelled"], s["expired"])

    def drain(self) -> None:
        """Run the scheduler until every submitted request is terminal.
        Raises NoProgressError after ``no_progress_limit`` consecutive
        steps that emitted no token and changed no request's state."""
        idle = 0
        while True:
            before = self._progress_marker()
            if not self.step():
                return
            if self._progress_marker() != before:
                idle = 0
                continue
            idle += 1
            if idle >= self.no_progress_limit:
                gating = {
                    "queued": len(self.queue),
                    "resident": len(self._live()),
                    "free_pages": (self.allocator.free_count()
                                   if self.paged else None),
                    "usable_pages": (self.allocator.usable_pages()
                                     if self.paged else None),
                    "quarantined": (len(self.allocator.quarantined_pages)
                                    + len(self.allocator.doomed_pages)
                                    if self.paged else 0),
                    "chaos_alloc_fail_p": self.cfg.chaos_alloc_fail_p,
                    "chaos_share_fail_p": self.cfg.chaos_share_fail_p,
                }
                raise NoProgressError(
                    f"drain() made no progress for {idle} consecutive "
                    f"steps: {gating}")

    def run(self, requests: list[Request]) -> list[Request]:
        self.submit(requests)
        self.drain()
        return requests
