"""Adaptive serve-tier cache policy (DESIGN.md §5.7).

A copy of ``repro.serve.adaptive`` (pure Python): the port keeps its own
so it never imports the JAX package, and draws its lattice from the
port's ``core.sweep``.

The paper's finding — no static GPU caching policy wins across MI
workloads, while runtime adaptation matches the best static choice —
applied to the serve tier's own caches.  ``AdaptivePolicy`` consumes the
engine's runtime counters (prefix hit rate over *fresh* admissions, page
reuse distance via a bounded last-touch ring, speculative-decode
acceptance, preemption/recompute cost) and drives three decisions the
static engine hard-codes:

* **warm prefix retention** — when a slot releases its pages, trie-
  registered prefix pages may be *retained* in the allocator's bounded
  warm tier (``cfg.warm_pages``) instead of freed, so a later request
  with the same prefix revives them without re-prefilling; warm pages
  are reclaimed (reuse-distance rank) when capacity is needed;
* **cost-aware preemption** — the eviction victim is the resident with
  the lowest estimated cost-to-recompute (prefill tokens to replay,
  discounted for shared pages that stay resident anyway) instead of
  youngest-first;
* **per-workload policy selection** — at re-plan boundaries (every
  ``cfg.adaptive_replan_every`` admission waves) the observed counters
  feed ``core.sweep.serve_policy_argmin``, an exact argmin over the
  (retention fraction x eviction rank x bypass) lattice, picking the
  combo per workload class.

Workload classes are keyed by the CRC32 of a prompt's first full KV
page (same system prompt -> same class); prompts too short to fill a
page fall into ``"short"``, and a first-ever-seen prefix is decided by
the aggregate ``"novel"`` class — which is how churn traces (every
prompt unique) learn to bypass retention globally instead of paying the
optimistic default once per prefix.

Everything here is **placement-only**: retention, reclaim order, victim
choice and re-planning move pages and slots, never tokens.  Outputs are
bit-identical to the static engine by construction — recompute-restore
is bit-exact regardless of victim (the ``(seed, token index)`` sampler
keys), and a warm revive attaches pages holding exactly the KV a fresh
prefill would recompute.  The identity matrix in ``tests/test_serve.py``
and the chaos/recovery legs pin this; ``tests/test_torch_adaptive.py``
holds the port's engine to it and to the reference's counters.
"""
from __future__ import annotations

import dataclasses
import zlib

from repro_torch.core.sweep import SERVE_COMBOS, serve_policy_argmin

# Bounded last-touch ring: page-level recency is a hint for reclaim
# ordering, not ground truth, so it is capped (and deliberately NOT
# snapshotted — the warm cache is volatile across crash-restore).
LAST_TOUCH_RING = 256

# Aggregate classes: prompts with no full page to key on, and the
# first-arrival pool whose outcomes teach the default retention stance.
CLASS_SHORT = "short"
CLASS_NOVEL = "novel"


@dataclasses.dataclass(frozen=True)
class ServeCombo:
    """One row of the serve-policy lattice (``core.sweep.SERVE_COMBOS``)."""

    warm_frac: float      # fraction of cfg.warm_pages this class may hold
    evict_rank: str       # "lru" | "reuse" — warm reclaim ordering
    bypass: bool          # never retain this class's pages

    @classmethod
    def from_row(cls, row) -> "ServeCombo":
        return cls(warm_frac=row[0], evict_rank=row[1], bypass=row[2])

    def to_json(self) -> list:
        return [self.warm_frac, self.evict_rank, self.bypass]


DEFAULT_COMBO = ServeCombo.from_row(SERVE_COMBOS[0])


def _class_stats() -> dict:
    return {
        "arrivals": 0,          # fresh admissions of this class
        "prompt_tokens": 0,     # sum of prompt lengths
        "shared_tokens": 0,     # sum of shareable (full-page prefix) tokens
        "retained": 0,          # pages parked warm on this class's behalf
        "hits": 0,              # warm pages later revived by a sharer
        "reclaimed_unhit": 0,   # warm pages reclaimed without ever reviving
        "last_wave": -1,        # wave of the most recent arrival
        "interval_ema": 0.0,    # EMA of waves between re-arrivals
        "reuse_obs": 0,         # re-arrival intervals observed
    }


class AdaptivePolicy:
    """Counter-driven policy controller for one ``ServeEngine``.

    The engine owns every mechanism (allocator warm tier, trie, victim
    preemption); this class owns only the decisions, so the static
    engine path never constructs one and pays nothing.  All state is
    host-side plain Python; :meth:`snapshot_state` emits the JSON-safe
    subset that must survive crash-restore (per-class counters and
    chosen combos — NOT the page-level recency ring, since restored
    engines start with a cold pool).
    """

    def __init__(self, warm_pages: int, replan_every: int, page_size: int,
                 spec_k: int = 0, pinned: ServeCombo | None = None):
        assert warm_pages >= 0 and replan_every >= 1 and page_size >= 1
        self.warm_pages = warm_pages
        self.replan_every = replan_every
        self.page_size = page_size
        self.spec_k = spec_k
        self.pinned = pinned          # static-baseline benches: never replan
        self.wave = 0
        self.replans = 0
        self._classes: dict[str, dict] = {}
        self._combos: dict[str, ServeCombo] = {}
        # Page-level, volatile (not snapshotted):
        self._last_touch: dict[int, int] = {}   # page -> wave, bounded ring
        self._page_class: dict[int, str] = {}   # warm page -> deciding class
        self._page_hit: set[int] = set()        # warm pages revived >= once

    # -- class taxonomy -----------------------------------------------------

    def class_key(self, chunks) -> str:
        """Workload-class key for a prompt: CRC32 of its first full KV
        page (deterministic across processes, unlike ``hash``), or
        ``"short"`` when no full page exists to key on."""
        if not chunks:
            return CLASS_SHORT
        first = chunks[0]
        data = b"".join(int(t).to_bytes(8, "little", signed=True)
                        for t in first)
        return f"c{zlib.crc32(data):08x}"

    def _cls(self, key: str) -> dict:
        st = self._classes.get(key)
        if st is None:
            st = self._classes[key] = _class_stats()
        return st

    def combo_for(self, key: str) -> ServeCombo:
        """The active combo for a retention decision on class ``key``:
        a pinned combo if set, the class's replanned combo if it has
        one, else the aggregate ``"novel"`` combo (first-seen prefixes
        inherit what churn history taught), else the optimistic
        default."""
        if self.pinned is not None:
            return self.pinned
        return self._combos.get(
            key, self._combos.get(CLASS_NOVEL, DEFAULT_COMBO)
        )

    # -- counter feed (called by the engine) --------------------------------

    def begin_wave(self) -> None:
        self.wave += 1

    def note_arrival(self, key: str, prompt_len: int,
                     shared_tokens: int) -> str:
        """Account one FRESH admission; returns the *deciding* class —
        the key itself once the class has history, else ``"novel"`` —
        which is the class retention outcomes accrue to."""
        st = self._cls(key)
        deciding = key if st["arrivals"] > 0 else CLASS_NOVEL
        if st["arrivals"] > 0 and st["last_wave"] >= 0:
            interval = max(self.wave - st["last_wave"], 1)
            st["interval_ema"] = (
                interval if st["reuse_obs"] == 0
                else 0.5 * st["interval_ema"] + 0.5 * interval
            )
            st["reuse_obs"] += 1
        st["arrivals"] += 1
        st["prompt_tokens"] += int(prompt_len)
        st["shared_tokens"] += int(shared_tokens)
        st["last_wave"] = self.wave
        if deciding == CLASS_NOVEL:
            nv = self._cls(CLASS_NOVEL)
            nv["arrivals"] += 1
            nv["prompt_tokens"] += int(prompt_len)
            nv["shared_tokens"] += int(shared_tokens)
            nv["last_wave"] = self.wave
        return deciding

    def touch(self, pages) -> None:
        """Refresh the last-touch ring for pages referenced this wave."""
        for p in pages:
            self._last_touch.pop(p, None)
            self._last_touch[p] = self.wave
        while len(self._last_touch) > LAST_TOUCH_RING:
            self._last_touch.pop(next(iter(self._last_touch)))

    def note_retained(self, page: int, deciding_class: str) -> None:
        self._cls(deciding_class)["retained"] += 1
        self._page_class[page] = deciding_class
        self._page_hit.discard(page)
        self.touch([page])

    def note_revived(self, pages) -> None:
        """Warm pages re-attached by a new sharer: the hit that justifies
        retention.  Credits each page's deciding class once per page."""
        for p in pages:
            cls = self._page_class.get(p)
            if cls is not None and p not in self._page_hit:
                self._cls(cls)["hits"] += 1
                self._page_hit.add(p)
            self._page_class.pop(p, None)
        self.touch(pages)

    def note_reclaimed(self, pages) -> None:
        """Warm pages returned to the free list: any page never revived
        since retention is churn — evidence against retaining its
        class."""
        for p in pages:
            cls = self._page_class.pop(p, None)
            if cls is not None and p not in self._page_hit:
                self._cls(cls)["reclaimed_unhit"] += 1
            self._page_hit.discard(p)
            self._last_touch.pop(p, None)

    # -- decisions (consulted by the engine) --------------------------------

    def retain_quota(self, key: str) -> int:
        """Max warm pages the deciding class of ``key`` may hold right
        now (0 = don't retain).  The allocator's global budget still
        bounds the total; this bounds one class's share of it."""
        combo = self.combo_for(key)
        if combo.bypass:
            return 0
        return int(combo.warm_frac * self.warm_pages)

    def class_warm_count(self, deciding_class: str) -> int:
        return sum(1 for c in self._page_class.values()
                   if c == deciding_class)

    def reclaim_order(self, warm_ids) -> list[int]:
        """Warm pages ordered most-reclaimable first.  LRU-ranked pages
        score by age alone; reuse-ranked pages (their class combo says
        "reuse") normalize age by the class's observed re-arrival
        interval, so a page overdue relative to its own cadence reclaims
        before a merely old page whose class re-arrives slowly.  Fully
        deterministic: ties break on page id."""
        def score(p: int) -> float:
            age = float(self.wave - self._last_touch.get(p, -1))
            cls = self._page_class.get(p)
            combo = self.combo_for(cls) if cls is not None else DEFAULT_COMBO
            if combo.evict_rank == "reuse" and cls in self._classes:
                ema = self._classes[cls]["interval_ema"]
                if ema > 0:
                    age = age / ema
            return age
        return sorted(warm_ids, key=lambda p: (-score(p), p))

    def victim_cost(self, record, allocator, page_table) -> int:
        """Estimated tokens to recompute if ``record`` is preempted:
        the full recompute-prefill length (prompt + emitted so far)
        minus one page's worth per page that other slots still share —
        those pages stay resident, so their KV isn't really lost."""
        replay = len(record.prompt) + len(record.generated)
        shared = sum(1 for p in page_table if allocator.ref_count(p) > 1)
        return replay - self.page_size * shared

    # -- re-planning --------------------------------------------------------

    def should_replan(self) -> bool:
        return (self.pinned is None
                and self.wave > 0
                and self.wave % self.replan_every == 0)

    def replan(self, engine_stats: dict) -> dict[str, list]:
        """Feed each class's counters through the exact lattice argmin
        (``core.sweep.serve_policy_argmin``) and install the winning
        combos.  Deterministic: classes visit in sorted key order.
        Returns ``{class: combo_json}`` for ``policy_report()``."""
        spec_rounds = engine_stats.get("spec_rounds", 0)
        # "spec_accepted" is the reference's key; neither engine counts it
        # (both count "draft_accepted"), so this feeds 0.  Kept as is so the
        # port's plans equal the reference's.
        spec_acc = (engine_stats.get("spec_accepted", 0) / spec_rounds
                    if spec_rounds else 0.0)
        for key in sorted(self._classes):
            st = self._classes[key]
            if st["arrivals"] == 0:
                continue
            # A class with no retention outcomes and no observed reuse of
            # its own has nothing to argmin over — installing a combo for
            # it would just echo the lattice tie-break AND shadow the
            # aggregate "novel" combo that holds the churn evidence its
            # first-arrival outcomes accrued to.  Keep it inheriting.
            if (key != CLASS_NOVEL and st["retained"] == 0
                    and st["hits"] == 0 and st["reuse_obs"] == 0):
                continue
            row, _cost = serve_policy_argmin({
                "prompt_mean": st["prompt_tokens"] / st["arrivals"],
                "shared_tokens": st["shared_tokens"] / st["arrivals"],
                "hit_rate": (st["hits"] / st["retained"]
                             if st["retained"] else 0.0),
                "churn": (st["reclaimed_unhit"] / st["retained"]
                          if st["retained"] else 0.0),
                "reuse_signal": 1.0 if st["reuse_obs"] > 0 else 0.0,
                "spec_acceptance": spec_acc,
                "spec_k": self.spec_k,
                "warm_budget": self.warm_pages,
                "page_size": self.page_size,
            })
            self._combos[key] = ServeCombo.from_row(row)
        self.replans += 1
        return {k: c.to_json() for k, c in sorted(self._combos.items())}

    # -- crash safety (serve.snapshot) --------------------------------------

    def snapshot_state(self) -> dict:
        """JSON-safe policy state for the checksummed snapshot payload.
        Page-level recency/attribution is deliberately absent: a
        restored engine's pool starts cold (no warm pages survive a
        crash), so only the learned per-class knowledge carries over."""
        return {
            "wave": self.wave,
            "replans": self.replans,
            "classes": {k: dict(v) for k, v in self._classes.items()},
            "combos": {k: c.to_json() for k, c in self._combos.items()},
        }

    def restore_state(self, payload: dict) -> None:
        self.wave = int(payload.get("wave", 0))
        self.replans = int(payload.get("replans", 0))
        self._classes = {
            k: {**_class_stats(), **v}
            for k, v in payload.get("classes", {}).items()
        }
        self._combos = {
            k: ServeCombo(warm_frac=float(v[0]), evict_rank=str(v[1]),
                          bypass=bool(v[2]))
            for k, v in payload.get("combos", {}).items()
        }
        self._last_touch.clear()
        self._page_class.clear()
        self._page_hit.clear()

    def report(self) -> dict:
        """Summary block for ``ServeEngine.policy_report()``."""
        return {
            "wave": self.wave,
            "replans": self.replans,
            "classes": len(self._classes),
            "combos": {k: c.to_json() for k, c in sorted(self._combos.items())},
            "warm_budget": self.warm_pages,
        }
