"""Refcounted host-side page allocator for the paged KV pool.

A copy of ``repro.serve.alloc`` (pure Python): the port keeps its own so
it never imports the JAX package.  The engine uses ``alloc``, ``share``
and ``release``, under the adaptive policy the warm tier (``retain``,
``revive``, ``reclaim``), and under KV integrity ``quarantine``.
"""
from __future__ import annotations


class PageAllocator:
    """Refcounted host-side LIFO free-list over a fixed page pool
    (DESIGN.md §5.2, refcounts §5.4, quarantine §5.6).

    Every held page carries a reference count: ``alloc`` hands out pages
    at refcount 1, ``share`` adds a reference to already-held pages (a new
    slot's page table aliasing a resident prefix page), and ``release``
    drops one — a page returns to the free list only at refcount zero, so
    a shared prefix page survives its original owner finishing.

    ``quarantine`` takes a page out of circulation permanently (KV
    integrity, DESIGN.md §5.6): a free page leaves the free list at once,
    a held page is marked *doomed* and diverts to the quarantine set —
    never back to the free list — when its last reference drops.  ``alloc``
    can therefore never hand out a quarantined page.

    The *warm* tier (adaptive policy, DESIGN.md §5.7) is a bounded
    holding pen between free and held: ``retain`` parks a just-freed page
    (its device KV intact) so a future sharer can ``revive`` it straight
    to refcount 1 without re-prefilling, and ``reclaim`` returns warm
    pages to the free list when capacity is needed.  The allocator owns
    only the *mechanism* — which pages to retain, revive, or reclaim (and
    in what order) is the adaptive controller's policy.  ``alloc`` never
    touches warm pages: the engine reclaims explicitly first, keeping
    allocation deterministic and the chaos ``alloc`` override oblivious.

    Invariants (property-tested in ``tests/test_alloc_property.py``,
    including a hypothesis state machine over alloc/share/release
    interleavings):

    * a page is never handed out twice without an intervening final
      ``release``,
    * ``alloc`` is atomic and never over-commits — when ``n`` exceeds the
      free count it returns None having popped nothing (admission
      gating; the guard predates refcounting but was untested, and is
      now pinned by a regression test),
    * no page is freed while references remain, and references are
      conserved across share/release interleavings,
    * held + free + warm + quarantined is a partition of the pool at all
      times (no leaks; ``warm`` and ``quarantined`` are empty until
      retention/integrity use them),
    * the warm set never exceeds ``warm_budget`` and never intersects
      the free list, the refcount map, or the quarantine set.
    """

    def __init__(self, n_pages: int, warm_budget: int = 0):
        assert n_pages >= 0
        assert warm_budget >= 0
        self.n_pages = n_pages
        self.warm_budget = warm_budget
        self._free = list(range(n_pages))
        self._refs: dict[int, int] = {}
        self._warm: set[int] = set()          # retained; KV intact, refs == 0
        self._quarantined: set[int] = set()   # out of circulation, refs == 0
        self._doomed: set[int] = set()        # held; quarantine at last release

    @property
    def free_pages(self) -> list[int]:
        return list(self._free)

    @property
    def held_pages(self) -> set[int]:
        return set(self._refs)

    @property
    def warm_pages(self) -> set[int]:
        """Pages retained past refcount zero (device KV intact)."""
        return set(self._warm)

    @property
    def quarantined_pages(self) -> set[int]:
        """Pages permanently out of circulation (refcount 0)."""
        return set(self._quarantined)

    @property
    def doomed_pages(self) -> set[int]:
        """Held pages marked for quarantine at their last release."""
        return set(self._doomed)

    def free_count(self) -> int:
        return len(self._free)

    def warm_count(self) -> int:
        return len(self._warm)

    def is_warm(self, page: int) -> bool:
        return page in self._warm

    def is_free(self, page: int) -> bool:
        return page in self._free

    def retain(self, page: int) -> bool:
        """Park a FREE page in the warm tier instead of leaving it on the
        free list (its device KV stays valid until reclaimed).  Returns
        False — having changed nothing — if the warm budget is full or
        ``page`` is not currently free (atomic, like ``alloc``)."""
        if not (0 <= page < self.n_pages):
            raise ValueError(f"retain({page}) outside pool")
        if len(self._warm) >= self.warm_budget or page not in self._free:
            return False
        self._free.remove(page)
        self._warm.add(page)
        return True

    def reclaim(self, ids) -> list[int]:
        """Return warm pages to the free list (their KV is forfeit; the
        engine drops trie nodes and integrity stamps first).  Every id
        must be warm — reclaiming a free/held page is a policy bug."""
        ids = list(ids)
        assert len(ids) == len(set(ids)), f"duplicate ids in reclaim: {ids}"
        bad = [i for i in ids if i not in self._warm]
        assert not bad, f"reclaiming pages not warm: {bad}"
        for i in ids:
            self._warm.discard(i)
            self._free.append(i)
        return ids

    def revive(self, ids) -> bool:
        """Promote warm pages straight to held at refcount 1 (a new
        sharer attaches to the retained KV without re-prefilling).
        Atomic: every id must be warm or nothing moves.  Returns True —
        deliberately NOT overridden by the chaos allocator: a revive only
        happens for pages the engine just confirmed warm, so a seeded
        refusal here would model an impossible failure."""
        ids = list(ids)
        assert len(ids) == len(set(ids)), f"duplicate ids in revive: {ids}"
        bad = [i for i in ids if i not in self._warm]
        assert not bad, f"reviving pages not warm: {bad}"
        for i in ids:
            self._warm.discard(i)
            self._refs[i] = 1
        return True

    def usable_pages(self) -> int:
        """Pool capacity excluding quarantined and doomed pages — the
        honest upper bound an admission gate may promise against."""
        return self.n_pages - len(self._quarantined) - len(self._doomed)

    def quarantine(self, page: int) -> bool:
        """Take ``page`` out of circulation (corrupt KV, DESIGN.md §5.6).

        A free (or warm) page moves to the quarantine set immediately; a
        held page is marked doomed and diverts there — never back to the
        free list — when its final reference is released.  Returns False
        if the page was already quarantined/doomed (idempotent)."""
        if not (0 <= page < self.n_pages):
            raise ValueError(f"quarantine({page}) outside pool")
        if page in self._quarantined or page in self._doomed:
            return False
        if page in self._refs:
            self._doomed.add(page)
        elif page in self._warm:
            self._warm.discard(page)
            self._quarantined.add(page)
        else:
            self._free.remove(page)
            self._quarantined.add(page)
        return True

    def ref_count(self, page: int) -> int:
        """Current reference count of ``page`` (0 if free)."""
        return self._refs.get(page, 0)

    def total_refs(self) -> int:
        return sum(self._refs.values())

    def alloc(self, n: int) -> list[int] | None:
        """Pop ``n`` pages (LIFO) at refcount 1, or None — having popped
        NOTHING — if the pool can't cover all ``n`` (atomic failure)."""
        if n < 0:
            raise ValueError(f"alloc({n})")
        if n > len(self._free):
            return None
        ids = [self._free.pop() for _ in range(n)]
        assert not any(i in self._refs for i in ids), "double-allocated page"
        for i in ids:
            self._refs[i] = 1
        return ids

    def share(self, ids) -> bool:
        """Add one reference to each held page in ``ids`` (a new sharer's
        page table now aliases them).  Sharing a free page is a bug.
        Returns True; the chaos subclass returns False on an injected
        refusal having touched no refcount (atomic, like ``alloc``)."""
        ids = list(ids)
        assert len(ids) == len(set(ids)), (
            f"duplicate page ids in share(): {ids}"
        )
        bad = [i for i in ids if i not in self._refs]
        assert not bad, f"sharing pages not held: {bad}"
        for i in ids:
            self._refs[i] += 1
        return True

    def release(self, ids) -> list[int]:
        """Drop one reference per page; pages reaching refcount zero
        return to the free list — or to quarantine if doomed.  Returns
        the ids no longer held (the engine evicts their trie nodes and
        drops their integrity stamps), whether freed or quarantined."""
        ids = list(ids)
        assert len(ids) == len(set(ids)), (
            f"duplicate page ids in free(): {ids}"
        )
        bad = [i for i in ids if i not in self._refs]
        assert not bad, f"freeing pages not held: {bad}"
        freed = []
        for i in ids:
            self._refs[i] -= 1
            if self._refs[i] == 0:
                del self._refs[i]
                if i in self._doomed:
                    self._doomed.discard(i)
                    self._quarantined.add(i)
                else:
                    self._free.append(i)
                freed.append(i)
        return freed

    # Unshared call sites (and the pre-refcount test suite) say "free":
    # with every refcount at 1 release IS free.
    free = release
