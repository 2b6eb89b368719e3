"""Continuous-batching serve engine over a paged (or contiguous) KV cache,
with prefix sharing and the request lifecycle: the port of
``repro.serve.engine`` without speculative decode, snapshots or the
adaptive policy.

* **Chunked decode with one host sync per chunk.**  A chunk is a Python
  loop of ``chunk_size`` single-token decode steps with on-device greedy
  sampling; tokens, budgets and done flags stay on the device, and the
  chunk's emitted tokens come back in one device-to-host copy.
* **Ragged slots.**  Finished slots park (``seg_lens == 0`` leaves their KV
  and cursor untouched, including through the kernels, which still run
  for them with ``kv_len = lengths`` and ``q_len = 0``); freed slots take
  new prompts mid-stream through a right-padded ragged prefill.
* **In-place state.**  The reference donates the cache and loop vectors to
  each jitted dispatch; here the model writes the KV buffers in place and
  the engine rebinds the small per-slot vectors after each step.
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
  prompt + emitted tokens (greedy, so the restored stream is the same
  stream).  ``cancel()`` and deadlines are swept at chunk boundaries,
  ``max_queue`` rejects with a reason, ``check_invariants()`` audits the
  slot/queue/allocator/trie state (after every wave under chaos or
  ``strict_invariants``), and ``drain()`` raises ``NoProgressError`` when
  it stops making progress.  With ``preemption=False`` a gated head waits.
* **Chaos** (``serve.chaos``).  Seeded alloc and share refusals and forced
  preemptions, drawn as the reference draws them.
* **Recurrent families** (mamba2, zamba2).  Re-admission zeroes a slot's
  SSM state and conv window (``reset_slots``); a paged config whose cache
  has no pages (mamba2) runs contiguous bookkeeping.

Not ported yet, and refused at construction: speculative decode, KV
integrity and page corruption, crash points, the adaptive policy, the
request journal and non-greedy sampling (and, through ``build_model``, the
MoE, encdec and VLM families).
"""
from __future__ import annotations

import collections
import dataclasses
import os
import time

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.models.common import paged_kv_spec
from repro_torch.serve.alloc import PageAllocator
from repro_torch.serve.chaos import ChaosAllocator
from repro_torch.serve.prefix import PrefixIndex
from repro_torch.serve.sampling import Sampler


@dataclasses.dataclass
class Request:
    prompt: np.ndarray            # (len,) int32
    max_new_tokens: int = 16
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
    ttft_s: float | None = None        # first admission -> first token
    queue_wait_s: float | None = None  # submit -> first admission
    submit_t: float | None = None
    admit_t: float | None = None


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


def _refuse_unported(cfg: ModelConfig, journal_path) -> None:
    unported = {
        "spec_k > 0": cfg.spec_k > 0,
        "chaos_corrupt_p": cfg.chaos_corrupt_p > 0,
        "chaos_crash_after_wave": cfg.chaos_crash_after_wave > 0,
        "kv_integrity": cfg.kv_integrity,
        "adaptive": cfg.adaptive,
        "journal_path": journal_path is not None,
    }
    on = [name for name, flag in unported.items() if flag]
    if on:
        raise NotImplementedError(
            f"ServeEngine: {', '.join(on)} not ported yet (ROADMAP.md "
            "queue 1 lists the engine slices still to come)")
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
    device-resident chunks, finished slots free at chunk boundaries and
    are re-admitted from the queue."""

    def __init__(self, cfg: ModelConfig, params, batch_slots: int,
                 max_len: int, chunk_size: int = 8,
                 n_pages: int | None = None, max_queue: int | None = None,
                 journal_path: str | None = None,
                 no_progress_limit: int = 256, device=None):
        self.device = resolve_device(device)
        _refuse_unported(cfg, journal_path)
        self.sampler = Sampler.from_config(cfg)
        self.params = params
        self.slots = batch_slots
        self.max_len = max_len
        self.chunk_size = max(1, chunk_size)
        self.paged = cfg.cache_layout == "paged"
        self.cfg = cfg
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
        # The decode kernels' split count is cfg.decode_splits, or planned by
        # the decode-attention ops at each step (plan_splits, no engine plan).
        self.model = build_model(cfg, self.device)
        self.cache = self.model.init_cache(
            params, batch=batch_slots, max_len=max_len,
            n_pages=self.n_pages if self.paged else None)
        # A cache with no KV to page (mamba2's decode state is O(1) per
        # slot) falls back to contiguous bookkeeping: no allocator, no page
        # table, no admission gated on a phantom pool.
        self.paged = self.paged and "pages" in self.cache
        if self.paged:
            self.allocator = self._make_allocator()
            self.page_table = np.full(
                (batch_slots, self.pages_per_slot), -1, np.int32)
            self._slot_pages: list[list[int]] = [[] for _ in range(batch_slots)]
        # Prefix sharing rides the paged pool, pure-KV decoders only: the
        # recurrent state of mamba2/zamba2 is not page-shareable.
        self.prefix_sharing = (bool(cfg.prefix_sharing) and self.paged
                               and cfg.family in ("dense", "moe"))
        self.prefix = (PrefixIndex(self.page_size) if self.prefix_sharing
                       else None)
        # Device-resident per-slot loop state: last sampled token and
        # remaining budget (0 == parked or free).
        self.cur_tok = torch.zeros(batch_slots, dtype=torch.int32,
                                   device=self.device)
        self.remaining = torch.zeros_like(self.cur_tok)
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
                            or cfg.chaos_share_fail_p > 0.0))
        self._strict = cfg.strict_invariants or (
            os.environ.get("REPRO_STRICT_INVARIANTS", "") not in ("", "0"))
        self.no_progress_limit = max(1, no_progress_limit)
        self.stats = {
            "host_syncs": 0,          # device->host copies (1/wave, 1/chunk)
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
        }

    def _make_allocator(self) -> PageAllocator:
        """The pool allocator; the chaos wrapper when an alloc or share
        refusal rate is set (seeded as the reference seeds it)."""
        cfg = self.cfg
        if cfg.chaos_alloc_fail_p > 0.0 or cfg.chaos_share_fail_p > 0.0:
            return ChaosAllocator(self.n_pages, cfg.chaos_alloc_fail_p,
                                  cfg.chaos_seed,
                                  share_fail_p=cfg.chaos_share_fail_p)
        return PageAllocator(self.n_pages)

    @property
    def free_pages(self) -> list[int]:
        """Free-list view (paged only)."""
        return self.allocator.free_pages

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

    def cancel(self, request_id: str) -> bool:
        """Ask for a queued or resident request to be cancelled at the next
        lifecycle sweep (a chunk boundary); ``generated`` keeps what was
        emitted.  False for unknown or already-terminal ids."""
        r = self._by_id.get(request_id)
        if r is None or r.done:
            return False
        r.cancel_requested = True
        return True

    def results(self) -> dict[str, list[int]]:
        """Emitted tokens per request id."""
        return {rid: list(r.generated) for rid, r in self._by_id.items()}

    def serve_stats(self) -> dict:
        out = dict(self.stats)
        total = out["decode_tokens"] + out["prefill_tokens"]
        out["host_syncs_per_token"] = out["host_syncs"] / total if total else 0.0
        # Over fresh admissions: a restore's re-attach is not a new hit.
        out["prefix_hit_rate"] = (
            out["prefix_hits_fresh"] / out["admitted_fresh"]
            if out["admitted_fresh"] else 0.0)
        deadlined = out["deadline_total"]
        out["goodput_under_deadline"] = (
            out["deadline_met"] / deadlined if deadlined else 1.0)
        return out

    # -- device steps --------------------------------------------------------

    @torch.inference_mode()
    def _prefill(self, tokens, seg_lens, start_lens, new_remaining):
        """Ragged admission prefill: set each admitted slot's cursor to its
        attach point (0, or the shared prefix's length), prefill the
        unshared suffix (seg_lens == 0 parks the others) and sample each
        admitted slot's first token on the device."""
        admitted = seg_lens > 0
        cache = self.model.reset_slots(self.cache, admitted)
        cache["lengths"] = torch.where(
            admitted, start_lens, cache["lengths"]).to(torch.int32)
        logits, self.cache = self.model.prefill(
            self.params, cache, tokens, seg_lens=seg_lens)
        nxt = self.sampler(logits)
        self.cur_tok = torch.where(admitted, nxt, self.cur_tok)
        self.remaining = torch.where(admitted, new_remaining, self.remaining)
        return nxt

    @torch.inference_mode()
    def _decode_chunk(self):
        """``chunk_size`` single-token steps for every slot; slots whose
        budget hits zero park.  Returns (chunk, b) tokens and active flags
        stacked into one device tensor."""
        tok, rem = self.cur_tok, self.remaining
        toks, actives = [], []
        for _ in range(self.chunk_size):
            active = rem > 0
            seg = active.to(torch.int32)
            logits, self.cache = self.model.decode_step(
                self.params, self.cache, tok[:, None], seg_lens=seg)
            tok = torch.where(active, self.sampler(logits), tok)
            rem = rem - seg
            toks.append(tok)
            actives.append(seg)
        self.cur_tok, self.remaining = tok, rem
        return torch.stack([torch.stack(toks), torch.stack(actives)])

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
            if self.prefix is not None and freed:
                self.prefix.evict(freed)
            self._slot_pages[slot] = []
            self.page_table[slot] = -1
        self._dirty_slots.add(slot)

    def _retire(self, r: Request, status: str) -> None:
        """Terminal transition for a non-finish exit (cancelled/expired)."""
        r.status = status
        r.done = True
        r.cancel_requested = False
        self.stats[status] += 1
        if r.deadline_s is not None:
            self.stats["deadline_total"] += 1

    def _finish(self, r: Request) -> None:
        r.done = True
        r.status = "finished"
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
        """The youngest never-preempted resident outside this wave, or None.
        A head that was itself preempted never preempts, so natural
        preemptions are bounded by the request count."""
        if not self.preemption or head.preempted_n > 0:
            return None
        cands = [r for i, r in enumerate(self.slot_req)
                 if r is not None and i not in wave_slots
                 and r.preempted_n == 0]
        if not cands:
            return None
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
        alloc back, so a gated head leaves every refcount untouched.
        Returns ``(table, chunks, shared_tokens)`` or ``(None, None, 0)``."""
        need = self._pages_needed(head)
        while True:
            shared, shared_len, chunks = [], 0, None
            if self.prefix is not None:
                chunks = self.prefix.chunks(eff)
                shared, shared_len = self._shared_prefix(eff, chunks)
            ids = self.allocator.alloc(need - len(shared))
            if ids is not None:
                if not shared or self.allocator.share(shared):
                    return shared + ids, chunks, shared_len
                self.allocator.release(ids)      # refused share: roll back
            victim = self._pick_victim(head, wave_slots)
            if victim is None:
                return None, None, 0
            self._preempt(victim)

    def _admit_wave(self) -> None:
        if self._chaos_rng is not None:
            self._chaos_forced_preempt()
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
            self.remaining = self.remaining.index_fill(
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
        seg = np.zeros((self.slots,), np.int32)
        start = np.zeros((self.slots,), np.int32)
        new_rem = np.zeros((self.slots,), np.int32)
        for slot, r, eff in wave:
            n = len(eff) - r.prefix_tokens
            self.stats["prefill_work_tokens"] += n
            toks[slot, :n] = eff[r.prefix_tokens:]
            seg[slot] = n
            start[slot] = r.prefix_tokens     # page-aligned attach cursor
            new_rem[slot] = r.max_new_tokens - len(r.generated) - 1
        if self.paged:
            self.cache["pages"] = torch.from_numpy(self.page_table.copy()).to(dev)
        nxt = self._prefill(torch.from_numpy(toks).to(dev),
                            torch.from_numpy(seg).to(dev),
                            torch.from_numpy(start).to(dev),
                            torch.from_numpy(new_rem).to(dev))
        first = nxt.cpu().numpy()                  # host sync: 1 per wave
        self.stats["host_syncs"] += 1
        self.stats["admission_waves"] += 1
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

    def _run_chunk(self) -> None:
        out = self._decode_chunk().cpu().numpy()   # host sync: 1 per chunk
        toks, actives = out[0], out[1]
        self.stats["host_syncs"] += 1
        self.stats["chunks"] += 1
        for slot, r in self._live():
            emitted = np.nonzero(actives[:, slot])[0]
            r.generated.extend(int(t) for t in toks[emitted, slot])
            self.stats["decode_tokens"] += len(emitted)
            if len(r.generated) >= r.max_new_tokens:
                self._finish(r)

    def check_invariants(self) -> None:
        """Raise AssertionError unless engine, allocator and trie state are
        conserved: each resident request sits in exactly the slot that maps
        it and is neither queued nor terminal; the allocator's held pages
        are exactly the union of resident slots' pages, with refcounts
        equal to the number of slots mapping each; free + held + warm +
        quarantined partitions the pool (no leaks); every trie page is
        held.  Identity (never ``==``) is used for request membership."""
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
        parts = (free + sorted(held) + sorted(self.allocator.warm_pages)
                 + sorted(self.allocator.quarantined_pages))
        check(sorted(parts) == list(range(self.n_pages)),
              "free + held + warm + quarantined is not a partition of the "
              "pool")
        if self.prefix is not None:
            stray = self.prefix.resident_pages() - held
            check(not stray, f"trie nodes outlive their pages: {stray}")

    def step(self) -> bool:
        """One scheduler tick: lifecycle sweep (cancel/expire), admission
        (with preemption), then one decode chunk if anything is resident.
        Returns True while work remains."""
        self._sweep_lifecycle()
        self._admit_wave()
        if any(r is not None for r in self.slot_req):
            self._run_chunk()
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
