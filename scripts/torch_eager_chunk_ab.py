"""Time the port's eager decode chunk against another checkout's, on one card.

    python3 scripts/torch_eager_chunk_ab.py --other DIR [--chunks 5]

``DIR`` is the root of another checkout of this repository (for example the
parent commit, unpacked with ``git archive``).  Four worker processes run in
the order other, this, this, other; each builds its checkout's CUDA kernels
(one nvcc per source, started together) and then, for yi-9b, zamba2-2.7b,
mamba2-1.3b and olmoe-1b-7b at full width (bf16, paged pool of 16-token
pages, pallas_paged, random weights from a seed), serves 16 prompts of 512
tokens on a ServeEngine of 16 slots x 2048 with chunks of 8 steps and the
CUDA graph off: one admission wave and one warm chunk, then ``--chunks``
chunks, each timed on the host clock to the end of its device-to-host copy.
Every slot stays active in every timed chunk, and both checkouts start each
model from the same weights and prompts, so the two eager loops do the same
work.  Where the engine has ``_check_static`` (the rebinding guard run before
each chunk), its host time is timed alone over 100 calls.

Prints one JSON line per worker and model, then a summary line with each
model's median chunk time on either side (the median over both workers of
that side) and their ratio, and exits non-zero if a worker failed.  Needs
one CUDA card.
"""
from __future__ import annotations

import argparse
import json
import os
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCHS = ("yi-9b", "zamba2-2.7b", "mamba2-1.3b", "olmoe-1b-7b")
SLOTS, MAX_LEN, CHUNK, PROMPT = 16, 2048, 8, 512


def worker(chunks: int, seed: int) -> None:
    """Time the eager chunk of the ``repro_torch`` found on ``sys.path``."""
    import dataclasses
    import inspect
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import torch

    from repro_torch import convert
    from repro_torch.kernels.common import build_library
    from repro_torch.models import get_config
    from repro_torch.serve.engine import Request, ServeEngine

    src = pathlib.Path(convert.__file__).resolve().parent
    t0 = time.perf_counter()
    with ThreadPoolExecutor() as pool:
        list(pool.map(build_library, sorted(src.glob("kernels/*/csrc/*.cu"))))
    build_s = time.perf_counter() - t0
    eager = ({"cuda_graph": False}
             if "cuda_graph" in inspect.signature(ServeEngine).parameters
             else {})
    for arch in ARCHS:
        cfg = dataclasses.replace(get_config(arch), cache_layout="paged",
                                  kv_page_size=16,
                                  decode_kernel="pallas_paged")
        gen = torch.Generator(device="cuda").manual_seed(seed)
        params = convert.init(cfg, gen, "cuda")
        rng = np.random.default_rng(seed + 2)
        eng = ServeEngine(cfg, params, batch_slots=SLOTS, max_len=MAX_LEN,
                          chunk_size=CHUNK, **eager)
        eng.submit([Request(
            prompt=rng.integers(0, cfg.vocab, PROMPT).astype(np.int32),
            max_new_tokens=2 + CHUNK * (chunks + 1)) for _ in range(SLOTS)])
        eng.step()                      # admission wave + one warm chunk
        chunk_ms = []
        for _ in range(chunks):
            t0 = time.perf_counter()
            eng._run_chunk()            # ends in the chunk's host copy
            chunk_ms.append(1e3 * (time.perf_counter() - t0))
        guard_ms = None
        if hasattr(eng, "_check_static"):
            t0 = time.perf_counter()
            for _ in range(100):
                eng._check_static()
            guard_ms = 10 * (time.perf_counter() - t0)
        live = sum(r is not None for r in eng.slot_req)
        print(json.dumps({"root": str(src.parents[1]), "arch": arch,
                          "build_s": build_s, "chunk_ms": chunk_ms,
                          "median_ms": statistics.median(chunk_ms),
                          "check_static_ms": guard_ms,
                          "live_slots_after": live}), flush=True)
        if live != SLOTS:
            raise AssertionError(f"{arch}: {live} slots live after the "
                                 f"timed chunks, not {SLOTS}")
        del eng, params
        torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", type=pathlib.Path)
    ap.add_argument("--chunks", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        worker(args.chunks, args.seed)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("torch_eager_chunk_ab: no CUDA device", file=sys.stderr)
        return 1
    other = args.other.resolve() if args.other else None
    if other is None or not (other / "src" / "repro_torch").is_dir():
        print("torch_eager_chunk_ab: --other must be a checkout's root",
              file=sys.stderr)
        return 1
    medians = {"other": {a: [] for a in ARCHS}, "this": {a: [] for a in ARCHS}}
    for side, root in (("other", other), ("this", ROOT), ("this", ROOT),
                       ("other", other)):
        env = dict(os.environ, PYTHONPATH=str(root / "src"))
        proc = subprocess.run(
            [sys.executable, str(pathlib.Path(__file__).resolve()),
             "--worker", "--chunks", str(args.chunks), "--seed",
             str(args.seed)], cwd=root, env=env, capture_output=True,
            text=True)
        sys.stderr.write(proc.stderr[-4000:])
        for line in proc.stdout.splitlines():
            if not line.startswith("{"):
                continue
            row = json.loads(line)
            print(json.dumps({"side": side} | row), flush=True)
            medians[side][row["arch"]].append(row["median_ms"])
        if proc.returncode != 0:
            print(f"torch_eager_chunk_ab: the {side} worker failed "
                  f"({proc.returncode})", file=sys.stderr)
            return 1
    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]
    summary = {}
    for arch in ARCHS:
        o = statistics.median(medians["other"][arch])
        t = statistics.median(medians["this"][arch])
        summary[arch] = {"other_ms": o, "this_ms": t, "this_over_other": t / o}
    print(json.dumps({"gpu": gpu, "eager_chunk_ms": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
