"""Fault injection for the serve tier (DESIGN.md §5.5, crash/integrity §5.6).

A copy of ``repro.serve.chaos`` (numpy only): the port keeps its own so it
never imports the JAX package, with the same seeded
``np.random.default_rng`` draws, so injected failures fall where the
reference's do.  The port's engine arms all of them: alloc/share
refusals, forced preemptions, crash points and page corruption.

Robustness of the engine's lifecycle state machine is only credible if
the failure paths actually run.  This module makes them run on demand:

* ``ChaosAllocator`` — a ``PageAllocator`` that, with seeded probability
  ``fail_p``, refuses an otherwise-satisfiable ``alloc``, and with
  ``share_fail_p`` an otherwise-satisfiable ``share`` (the alloc-own-
  then-share admission ordering's second failure point).  An injected
  failure is indistinguishable from genuine pool exhaustion to the
  engine, so it exercises the same gating/preemption/retry paths, while
  staying atomic (nothing popped, nothing referenced) and fully
  reproducible from the seed.
* forced preemptions — the engine consults ``cfg.chaos_preempt_p`` at
  wave boundaries and preempts a healthy resident (see
  ``ServeEngine._admit_wave``); that logic lives in the engine, this
  module only supplies the seeded RNG convention.
* crash points — ``cfg.chaos_crash_after_wave`` makes the engine raise
  ``ChaosCrash`` at the end of the step that completed admission wave N
  (journal flushed first, so on-disk state sits at a chunk boundary);
  the recovery harness restores a fresh engine from snapshot + journal.
* page corruption — ``cfg.chaos_corrupt_p`` flips a value inside a
  fingerprint-stamped KV page on device; ``verify_pages()`` must detect,
  quarantine and recompute-heal it (DESIGN.md §5.6).

Because every drop of state an injected fault perturbs is recomputed
from host-side truth (tokens, refcounts, page tables), a chaos run must
stay BIT-IDENTICAL to the fault-free run and end with zero leaked
pages — that is the acceptance gate in tests and the CI chaos leg.
"""
from __future__ import annotations

import numpy as np

from repro_torch.serve.alloc import PageAllocator


class ChaosCrash(RuntimeError):
    """Injected process kill (``cfg.chaos_crash_after_wave``).

    Raised at the end of a step, after the request journal has been
    flushed, so the on-disk snapshot + journal state corresponds exactly
    to a chunk boundary.  The crashed engine object is dead by contract:
    recovery constructs a fresh engine and calls ``restore``.
    """

    def __init__(self, wave: int):
        super().__init__(f"injected crash after admission wave {wave}")
        self.wave = wave


class ChaosAllocator(PageAllocator):
    """``PageAllocator`` with seeded, probabilistic alloc/share failures.

    Only positive-size calls can fail (``alloc(0)``/``share([])`` are
    no-ops the engine uses for fully-shared and fully-owned prefixes;
    failing them would fabricate a gating state the real allocator can
    never produce).  ``last_injected`` lets tests distinguish an injected
    refusal from a genuine out-of-pages refusal on the immediately
    preceding call.  Both failure modes are atomic: a refused ``share``
    perturbs no refcount, exactly as a refused ``alloc`` pops nothing.
    """

    def __init__(self, n_pages: int, fail_p: float, seed: int = 0,
                 share_fail_p: float = 0.0, warm_budget: int = 0):
        super().__init__(n_pages, warm_budget=warm_budget)
        assert 0.0 <= fail_p <= 1.0, fail_p
        assert 0.0 <= share_fail_p <= 1.0, share_fail_p
        self.fail_p = fail_p
        self.share_fail_p = share_fail_p
        self._rng = np.random.default_rng(seed)
        self.injected_failures = 0
        self.injected_share_failures = 0
        self.last_injected = False

    def alloc(self, n: int) -> list[int] | None:
        self.last_injected = False
        if n > 0 and self.fail_p > 0.0 and self._rng.random() < self.fail_p:
            self.injected_failures += 1
            self.last_injected = True
            return None
        return super().alloc(n)

    def share(self, ids) -> bool:
        self.last_injected = False
        ids = list(ids)
        if (ids and self.share_fail_p > 0.0
                and self._rng.random() < self.share_fail_p):
            self.injected_share_failures += 1
            self.last_injected = True
            return False
        return super().share(ids)
