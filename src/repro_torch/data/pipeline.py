"""Deterministic, step-indexed data pipeline (a copy of
``repro.data.pipeline`` over the port's ``ModelConfig``; numpy only, so
its batches are bitwise the reference's for the same ``(seed, step)``).

Restart-exactness is the fault-tolerance contract: batch(step) is a pure
function of (seed, step), so resuming from a checkpoint at step k replays
the identical stream with NO loader state to persist.  Sources:

* ``SyntheticLM`` — seeded token stream (plus stub vis/frames for VLM and
  enc-dec archs).
* ``MemmapLM`` — a flat uint32 token file (np.memmap), sampled at
  deterministic offsets; the standard "one big packed corpus" layout.

``Prefetcher`` overlaps host batch synthesis with device compute (a small
background thread pipeline, depth-bounded).
"""
from __future__ import annotations

import queue
import threading
from typing import Any, Iterator

import numpy as np

from repro_torch.configs.base import ModelConfig


class SyntheticLM:
    def __init__(self, cfg: ModelConfig, batch: int, seq: int, seed: int = 0):
        self.cfg, self.batch, self.seq, self.seed = cfg, batch, seq, seed

    def __call__(self, step: int) -> dict[str, np.ndarray]:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step])
        )
        toks = rng.integers(
            0, self.cfg.vocab, size=(self.batch, self.seq + 1), dtype=np.int32
        )
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if self.cfg.family == "vlm":
            batch["vis"] = rng.standard_normal(
                (self.batch, self.cfg.n_vis_tokens, self.cfg.d_model),
                dtype=np.float32,
            )
        if self.cfg.family == "encdec":
            batch["frames"] = rng.standard_normal(
                (self.batch, min(self.cfg.enc_seq, self.seq), self.cfg.d_model),
                dtype=np.float32,
            )
        return batch


class MemmapLM:
    """Packed-token corpus: deterministic strided sampling by step."""

    def __init__(self, path: str, cfg: ModelConfig, batch: int, seq: int,
                 seed: int = 0):
        self.tokens = np.memmap(path, dtype=np.uint32, mode="r")
        self.cfg, self.batch, self.seq, self.seed = cfg, batch, seq, seed
        self.n_windows = (len(self.tokens) - 1) // (seq + 1)
        if self.n_windows < batch:
            raise ValueError("corpus too small for batch")

    def __call__(self, step: int) -> dict[str, np.ndarray]:
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, step]))
        idx = rng.choice(self.n_windows, size=self.batch, replace=False)
        rows = np.stack([
            self.tokens[i * (self.seq + 1):(i + 1) * (self.seq + 1)]
            for i in idx
        ]).astype(np.int32)
        rows = np.minimum(rows, self.cfg.vocab - 1)
        return {"tokens": rows[:, :-1], "labels": rows[:, 1:]}


class Prefetcher:
    """Depth-bounded background prefetch of step-indexed batches."""

    def __init__(self, source, start_step: int, depth: int = 2):
        self.source = source
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._step = start_step
        self._thread = threading.Thread(target=self._work, daemon=True)
        self._thread.start()

    def _work(self):
        step = self._step
        while not self._stop.is_set():
            batch = self.source(step)
            while not self._stop.is_set():
                try:
                    self.q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __iter__(self) -> Iterator[tuple[int, dict[str, Any]]]:
        while True:
            yield self.q.get()

    def stop(self):
        self._stop.set()
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2)
