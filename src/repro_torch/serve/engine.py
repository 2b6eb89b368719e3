"""Continuous-batching serve engine over a paged (or contiguous) KV cache:
the core slice of ``repro.serve.engine``.

* **Chunked decode with one host sync per chunk.**  A chunk is a Python
  loop of ``chunk_size`` single-token decode steps with on-device greedy
  sampling; tokens, budgets and done flags stay on the device, and the
  chunk's emitted tokens come back in one device-to-host copy.
* **Ragged slots.**  Finished slots park (``seg_lens == 0`` leaves their KV
  and cursor untouched, including through the decode kernel, which still
  runs for them with ``kv_len = lengths``); freed slots take new prompts
  mid-stream through a right-padded ragged prefill.
* **In-place state.**  The reference donates the cache and loop vectors to
  each jitted dispatch; here the model writes the KV buffers in place and
  the engine rebinds the small per-slot vectors after each step.
* **Paged KV pool.**  A host-side ``PageAllocator`` assigns each admitted
  request the pages its worst case needs; admission is FIFO head-of-line
  gated on free pages.  When the pool is short the head waits: this slice
  does not preempt (the lifecycle slice does), which changes scheduling,
  never tokens.

Not ported yet, and refused at construction: prefix sharing, speculative
decode, chaos injection, KV integrity, the adaptive policy, the request
journal, non-greedy sampling and non-dense families.
"""
from __future__ import annotations

import collections
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.models.common import paged_kv_spec
from repro_torch.serve.alloc import PageAllocator
from repro_torch.serve.sampling import Sampler


@dataclasses.dataclass
class Request:
    prompt: np.ndarray            # (len,) int32
    max_new_tokens: int = 16
    id: str | None = None         # auto-assigned at submit when None
    generated: list = dataclasses.field(default_factory=list)
    slot: int = -1
    done: bool = False
    status: str = "new"           # new -> queued -> resident -> finished
    ttft_s: float | None = None        # admission -> first token
    queue_wait_s: float | None = None  # submit -> admission
    submit_t: float | None = None
    admit_t: float | None = None


class AdmissionReject(ValueError):
    """A request the engine refuses to enqueue, with a machine-readable
    ``reason`` ("max_len", "empty_prompt", "zero_budget",
    "pool_too_small", "duplicate_id").  Raised by ``submit`` before anything
    in the batch is enqueued."""

    def __init__(self, reason: str, message: str):
        super().__init__(message)
        self.reason = reason


def _pad_bucket(n: int, cap: int) -> int:
    """Round a prefill width up to a power of two (>= 8), capped at max_len."""
    b = 8
    while b < n:
        b *= 2
    return min(b, cap)


def _refuse_unported(cfg: ModelConfig, journal_path) -> None:
    unported = {
        "prefix_sharing": cfg.prefix_sharing,
        "spec_k > 0": cfg.spec_k > 0,
        "chaos_alloc_fail_p": cfg.chaos_alloc_fail_p > 0,
        "chaos_preempt_p": cfg.chaos_preempt_p > 0,
        "chaos_share_fail_p": cfg.chaos_share_fail_p > 0,
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
            "queue 1 item 5 lists the engine slices still to come)")


class ServeEngine:
    """Continuous-batching engine over a fixed pool of request slots.

    ``run(requests)`` (or ``submit`` + ``drain``) pushes requests through a
    FIFO queue: free slots are prefilled (ragged, right-padded), live slots
    decode in device-resident chunks, finished slots free at chunk
    boundaries and are re-admitted from the queue."""

    def __init__(self, cfg: ModelConfig, params, batch_slots: int,
                 max_len: int, chunk_size: int = 8,
                 n_pages: int | None = None, journal_path: str | None = None,
                 device=None):
        self.device = resolve_device(device)
        _refuse_unported(cfg, journal_path)
        self.sampler = Sampler.from_config(cfg)
        self.params = params
        self.slots = batch_slots
        self.max_len = max_len
        self.chunk_size = max(1, chunk_size)
        self.paged = cfg.cache_layout == "paged"
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
            self.allocator = PageAllocator(self.n_pages)
            self.page_table = np.full(
                (batch_slots, self.pages_per_slot), -1, np.int32)
            self._slot_pages: list[list[int]] = [[] for _ in range(batch_slots)]
        # The decode kernels' split count is cfg.decode_splits, or planned by
        # the decode-attention ops at each step (plan_splits, no engine plan).
        self.cfg = cfg
        self.model = build_model(cfg, self.device)
        self.cache = self.model.init_cache(
            params, batch=batch_slots, max_len=max_len,
            n_pages=self.n_pages if self.paged else None)
        # Device-resident per-slot loop state: last sampled token and
        # remaining budget (0 == parked or free).
        self.cur_tok = torch.zeros(batch_slots, dtype=torch.int32,
                                   device=self.device)
        self.remaining = torch.zeros_like(self.cur_tok)
        self.slot_req: list[Request | None] = [None] * batch_slots
        self.queue: collections.deque[Request] = collections.deque()
        self._by_id: dict[str, Request] = {}
        self._next_id = 0
        self.stats = {
            "host_syncs": 0,          # device->host copies (1/wave, 1/chunk)
            "decode_tokens": 0,       # tokens emitted by decode chunks
            "prefill_tokens": 0,      # first tokens emitted by prefill
            "chunks": 0,
            "admission_waves": 0,
            "peak_pages_held": 0,     # max concurrent pool usage (paged)
        }

    # -- requests ------------------------------------------------------------

    def _positions_needed(self, r: Request) -> int:
        """Prompt plus every decoded token but the last (never written)."""
        return len(r.prompt) + r.max_new_tokens - 1

    def _pages_needed(self, r: Request) -> int:
        return -(-self._positions_needed(r) // self.page_size)

    def submit(self, requests: list[Request]) -> None:
        """Validate the whole batch, then enqueue it (all or nothing)."""
        ids = set()
        for r in requests:
            if r.max_new_tokens < 1:
                raise AdmissionReject("zero_budget", (
                    f"max_new_tokens must be >= 1, got {r.max_new_tokens} "
                    "(prefill emits the first token at admission)"))
            if len(r.prompt) == 0:
                raise AdmissionReject("empty_prompt", (
                    "empty prompt: seg_lens == 0 marks a parked slot"))
            need = self._positions_needed(r)
            if need > self.max_len:
                raise AdmissionReject("max_len", (
                    f"request needs {need} cache positions, "
                    f"max_len={self.max_len}"))
            if self.paged and self._pages_needed(r) > self.n_pages:
                raise AdmissionReject("pool_too_small", (
                    f"request needs {self._pages_needed(r)} pages, pool has "
                    f"{self.n_pages}: it would block the FIFO queue forever"))
            if r.id is not None:
                prev = self._by_id.get(r.id)
                if (prev is not None and prev is not r) or r.id in ids:
                    raise AdmissionReject("duplicate_id", (
                        f"request id {r.id!r} already submitted"))
                ids.add(r.id)
        now = time.perf_counter()
        for r in requests:
            if r.id is None:
                r.id = f"req-{self._next_id}"
                self._next_id += 1
            self._by_id[r.id] = r
            r.submit_t = now
            r.status = "queued"
            self.queue.append(r)

    def results(self) -> dict[str, list[int]]:
        """Emitted tokens per request id."""
        return {rid: list(r.generated) for rid, r in self._by_id.items()}

    def serve_stats(self) -> dict:
        out = dict(self.stats)
        total = out["decode_tokens"] + out["prefill_tokens"]
        out["host_syncs_per_token"] = out["host_syncs"] / total if total else 0.0
        return out

    # -- device steps --------------------------------------------------------

    @torch.inference_mode()
    def _prefill(self, tokens, seg_lens, new_remaining):
        """Ragged admission prefill: rewind re-admitted slots, prefill their
        prompts (seg_lens == 0 parks the others) and sample each admitted
        slot's first token on the device."""
        admitted = seg_lens > 0
        cache = self.model.reset_slots(self.cache, admitted)
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

    def _release_slot(self, r: Request) -> None:
        """Vacate ``r``'s slot host-side.  The device page table is pushed
        at the next admission wave; until then the stale row is only read
        for a parked slot whose output is discarded."""
        slot = r.slot
        self.slot_req[slot] = None
        r.slot = -1
        if self.paged:
            self.allocator.release(self._slot_pages[slot])
            self._slot_pages[slot] = []
            self.page_table[slot] = -1

    def _finish(self, r: Request) -> None:
        r.done = True
        r.status = "finished"
        self._release_slot(r)

    def _admit_wave(self) -> None:
        wave: list[tuple[int, Request]] = []
        now = time.perf_counter()
        while self.queue:
            slot = next(
                (i for i, q in enumerate(self.slot_req) if q is None), None)
            if slot is None:
                break
            head = self.queue[0]
            if self.paged:
                # FIFO head-of-line gate: a request that does not fit waits
                # rather than being overtaken.
                table = self.allocator.alloc(self._pages_needed(head))
                if table is None:
                    break
                self._slot_pages[slot] = table
                self.page_table[slot] = -1
                self.page_table[slot, :len(table)] = table
            self.queue.popleft()
            head.admit_t = now
            head.queue_wait_s = now - head.submit_t
            head.status = "resident"
            head.slot = slot
            self.slot_req[slot] = head
            wave.append((slot, head))
        if not wave:
            return
        pad = _pad_bucket(max(len(r.prompt) for _, r in wave), self.max_len)
        toks = np.zeros((self.slots, pad), np.int32)
        seg = np.zeros((self.slots,), np.int32)
        new_rem = np.zeros((self.slots,), np.int32)
        for slot, r in wave:
            toks[slot, :len(r.prompt)] = r.prompt
            seg[slot] = len(r.prompt)
            new_rem[slot] = r.max_new_tokens - 1
        dev = self.device
        if self.paged:
            self.cache["pages"] = torch.from_numpy(self.page_table).to(dev)
        nxt = self._prefill(torch.from_numpy(toks).to(dev),
                            torch.from_numpy(seg).to(dev),
                            torch.from_numpy(new_rem).to(dev))
        first = nxt.cpu().numpy()                  # host sync: 1 per wave
        self.stats["host_syncs"] += 1
        self.stats["admission_waves"] += 1
        if self.paged:
            self.stats["peak_pages_held"] = max(
                self.stats["peak_pages_held"],
                self.n_pages - self.allocator.free_count())
        now = time.perf_counter()
        for slot, r in wave:
            r.generated.append(int(first[slot]))
            self.stats["prefill_tokens"] += 1
            r.ttft_s = now - r.admit_t
            if len(r.generated) >= r.max_new_tokens:
                self._finish(r)

    def _run_chunk(self) -> None:
        out = self._decode_chunk().cpu().numpy()   # host sync: 1 per chunk
        toks, actives = out[0], out[1]
        self.stats["host_syncs"] += 1
        self.stats["chunks"] += 1
        for slot, r in enumerate(self.slot_req):
            if r is None:
                continue
            emitted = np.nonzero(actives[:, slot])[0]
            r.generated.extend(int(t) for t in toks[emitted, slot])
            self.stats["decode_tokens"] += len(emitted)
            if len(r.generated) >= r.max_new_tokens:
                self._finish(r)

    def step(self) -> bool:
        """One scheduler tick: admission, then one decode chunk if anything
        is resident.  Returns True while work remains."""
        self._admit_wave()
        if any(r is not None for r in self.slot_req):
            self._run_chunk()
        return bool(self.queue) or any(r is not None for r in self.slot_req)

    def drain(self) -> None:
        """Run the scheduler until every submitted request has finished."""
        while self.step():
            pass

    def run(self, requests: list[Request]) -> list[Request]:
        self.submit(requests)
        self.drain()
        return requests
