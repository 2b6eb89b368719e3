"""Fault-tolerant training loop (the port of ``repro.train.loop``).

Production behaviours, all testable on one host:

* **Auto-resume**: restores the newest valid checkpoint (atomic-publish
  markers) into the given state, in place, and replays the deterministic
  data stream from that step.
* **Preemption**: SIGTERM/SIGINT set a flag; the loop finishes the in-flight
  step, writes a final checkpoint, and exits cleanly (exit early, never
  corrupt).
* **Straggler watchdog**: per-step wall time vs an EWMA baseline; slow steps
  are flagged through a callback — at fleet scale this is the hook that
  triggers hot-spare pod replacement; here it logs and counts.
* **Async checkpointing** every ``ckpt_every`` steps (write overlaps train).
* **NaN fuse**: a non-finite loss halts before it can poison the stream of
  checkpoints.
* **Sharded state**: ``shardings`` (a tree of ``distributed.sharding.
  Sharding`` beside the state, as ``train.step.state_shardings`` makes)
  goes to ``checkpoint.restore``, which cuts each stored leaf to this
  rank's block (the elastic path: resume at another number of ranks), and
  to the checkpointer: every rank gathers, rank 0 alone writes.  Every
  rank runs the loop; the loop itself prints nothing.
"""
from __future__ import annotations

import dataclasses
import math
import signal
import time
from typing import Any, Callable

from repro_torch.train import checkpoint as ckpt


@dataclasses.dataclass
class LoopConfig:
    total_steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: str = "checkpoints"
    keep: int = 3
    log_every: int = 10
    straggler_factor: float = 3.0     # step > factor x EWMA -> flagged
    ewma_alpha: float = 0.1
    handle_signals: bool = True


@dataclasses.dataclass
class LoopReport:
    final_step: int = 0
    losses: list = dataclasses.field(default_factory=list)
    straggler_steps: list = dataclasses.field(default_factory=list)
    preempted: bool = False
    resumed_from: int | None = None
    step_times: list = dataclasses.field(default_factory=list)


def run(
    train_step: Callable,
    state: Any,
    data_source: Callable[[int], dict],
    config: LoopConfig,
    shardings: Any = None,
    on_straggler: Callable[[int, float], None] | None = None,
    on_step: Callable[[int, dict], None] | None = None,
) -> tuple[Any, LoopReport]:
    report = LoopReport()
    preempt = {"flag": False}

    def _handler(signum, frame):
        preempt["flag"] = True

    old_handlers = {}
    if config.handle_signals:
        for sig in (signal.SIGTERM, signal.SIGINT):
            old_handlers[sig] = signal.signal(sig, _handler)

    start_step = 0
    if ckpt.latest_step(config.ckpt_dir) is not None:
        state, start_step = ckpt.restore(config.ckpt_dir, template=state,
                                         in_place=True, shardings=shardings)
        report.resumed_from = start_step
    saver = ckpt.AsyncCheckpointer(config.ckpt_dir, keep=config.keep,
                                   shardings=shardings)

    ewma = None
    step = start_step
    steps_in_run = 0
    try:
        while step < config.total_steps:
            # perf_counter, not time.time: an NTP step would make dt
            # negative/huge and poison the straggler-watchdog EWMA.
            t0 = time.perf_counter()
            batch = data_source(step)
            state, metrics = train_step(state, batch)
            # Per-step sync is the NaN fuse: the next line must observe
            # this step's loss before we commit to another step.
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            report.step_times.append(dt)

            if not math.isfinite(loss):
                raise FloatingPointError(f"non-finite loss at step {step}: {loss}")
            report.losses.append(loss)

            # Straggler watchdog (EWMA-baselined).  The first step of a run
            # is excluded — it carries warm-up cost and would inflate the
            # baseline.
            if steps_in_run == 0:
                pass
            elif ewma is None:
                ewma = dt
            else:
                if dt > config.straggler_factor * ewma:
                    report.straggler_steps.append(step)
                    if on_straggler is not None:
                        on_straggler(step, dt / ewma)
                ewma = (1 - config.ewma_alpha) * ewma + config.ewma_alpha * dt
            steps_in_run += 1

            step += 1
            if on_step is not None:
                on_step(step, metrics)
            if step % config.ckpt_every == 0 or step == config.total_steps:
                saver.save(state, step)
            if preempt["flag"]:
                report.preempted = True
                saver.save(state, step)
                break
    finally:
        saver.wait()
        if config.handle_signals:
            for sig, h in old_handlers.items():
                signal.signal(sig, h)

    report.final_step = step
    return state, report
