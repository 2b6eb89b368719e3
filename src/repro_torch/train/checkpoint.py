"""Async, atomic checkpointing of the port's train state (the port of
``repro.train.checkpoint``).

Layout (one directory per step), the reference's with a JSON manifest:

    <dir>/step_000100/
        manifest.json       {step, leaves: [{path, file, shape, dtype}]}
        leaf_00000.npy ...  one file per leaf, in ``tree.leaves_with_paths``
                            order
        _DONE               atomic publish marker (written last)

* **Atomic**: written into ``step_<k>.tmp`` then os.rename'd; readers only
  trust directories containing ``_DONE``.  A crash mid-write never corrupts
  the latest checkpoint.
* **Async**: ``AsyncCheckpointer.save`` copies the state to host memory on
  the caller's thread and writes files on a background thread, so training
  continues.  The copy is a real copy even for CPU tensors, whose
  ``.cpu()``/``.numpy()`` would alias the storage the next step updates in
  place.
* **bf16 without ml_dtypes**: numpy has no bfloat16, so such a leaf is
  stored as its raw 16-bit words (int16) with ``"dtype": "bfloat16"`` in
  the manifest, and restored bitwise.  These files are therefore not the
  reference's (msgpack manifest, ml_dtypes arrays).
* **Restore** reads into a template tree: in place (``in_place=True``,
  every leaf ``copy_``'d, nothing reallocated) or as new tensors on each
  template leaf's device.
* **Sharded state, elastic restore.**  Leaves are stored whole.  Given
  ``shardings`` (a tree of ``distributed.sharding.Sharding`` describing
  the blocks each rank holds, e.g. ZeRO-1's moments), a save gathers every
  leaf on the caller's thread (a collective: every rank calls it), rank 0
  alone writes, and the others wait at a barrier until the checkpoint is
  published; ``restore(..., shardings=)`` cuts each stored leaf to this
  rank's block of the new layout, so a checkpoint written at one number
  of ranks restores at another.
* **Retention**: ``keep`` most-recent checkpoints are preserved.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any

import numpy as np
import torch

from repro_torch.device import dtype_name, torch_dtype
from repro_torch.distributed.sharding import shard, unshard
from repro_torch.utils import tree

_DTYPES = {"int32": torch.int32, "int64": torch.int64}


def _dtype(name: str) -> torch.dtype:
    return _DTYPES.get(name) or torch_dtype(name)


def _name(dtype: torch.dtype) -> str:
    return next((n for n, t in _DTYPES.items() if t == dtype), None) or (
        dtype_name(dtype))


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.cpu().numpy()


def save(state: Any, directory: str, step: int, keep: int = 3,
         shardings: Any = None) -> str:
    """Synchronous checkpoint write. Returns the published path.  With
    ``shardings`` every rank calls it; rank 0 writes the gathered leaves
    and the others wait at a barrier until it has published."""
    if shardings is not None:
        state = gather_state(state, shardings)
    if _is_writer(shardings):
        final = _write(state, directory, step, keep)
    else:
        final = os.path.join(directory, f"step_{step:08d}")
    _barrier(shardings)
    return final


def _write(state: Any, directory: str, step: int, keep: int) -> str:
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {"step": step, "leaves": []}
    for i, (path, leaf) in enumerate(tree.leaves_with_paths(state)):
        fname = f"leaf_{i:05d}.npy"
        np.save(os.path.join(tmp, fname), _to_numpy(leaf))
        manifest["leaves"].append(
            {"path": tree.path_str(path), "file": fname,
             "shape": list(leaf.shape), "dtype": _name(leaf.dtype)})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    with open(os.path.join(tmp, "_DONE"), "w") as f:
        f.write("ok")
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _gc(directory, keep)
    return final


def host_copy(state: Any) -> Any:
    """The state as CPU tensors that share no storage with it."""
    return tree.tree_map(
        lambda t: t.detach().to("cpu", copy=True), state)


def _by_path(shardings: Any) -> dict:
    return {tree.path_str(p): s for p, s in tree.leaves_with_paths(shardings)}


def gather_state(state: Any, shardings: Any) -> Any:
    """Every leaf whole, gathered from the ranks' blocks (a collective)."""
    sh = _by_path(shardings)
    return tree.tree_map_with_path(
        lambda p, t: unshard(t.detach(), sh[tree.path_str(p)]), state)


def _is_writer(shardings: Any) -> bool:
    import torch.distributed as dist

    return shardings is None or not dist.is_initialized() or (
        dist.get_rank() == 0)


def _barrier(shardings: Any) -> None:
    import torch.distributed as dist

    if shardings is not None and dist.is_initialized():
        dist.barrier()


class AsyncCheckpointer:
    """Snapshot on the caller thread, write on a background thread.  With
    ``shardings`` every rank calls ``save`` and ``wait``: the leaves are
    gathered on the caller's thread, rank 0 writes, and ``wait`` holds
    every rank at a barrier until rank 0's write is published."""

    def __init__(self, directory: str, keep: int = 3, shardings: Any = None):
        self.directory = directory
        self.keep = keep
        self.shardings = shardings
        self._thread: threading.Thread | None = None
        self.last_error: Exception | None = None

    def save(self, state: Any, step: int) -> None:
        self.wait()
        if self.shardings is not None:
            state = gather_state(state, self.shardings)
        if not _is_writer(self.shardings):
            return
        host_state = host_copy(state)

        def _write():
            try:
                save(host_state, self.directory, step, keep=self.keep)
            except Exception as e:  # pragma: no cover
                self.last_error = e

        self._thread = threading.Thread(target=_write, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        _barrier(self.shardings)
        if self.last_error is not None:
            raise self.last_error


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    steps = []
    for name in os.listdir(directory):
        if name.startswith("step_") and not name.endswith(".tmp"):
            if os.path.exists(os.path.join(directory, name, "_DONE")):
                steps.append(int(name.split("_")[1]))
    return max(steps) if steps else None


def _load(path: str, rec: dict) -> torch.Tensor:
    arr = np.load(os.path.join(path, rec["file"]))
    t = torch.from_numpy(arr)
    if rec["dtype"] == "bfloat16":
        t = t.view(torch.bfloat16)
    if t.dtype != _dtype(rec["dtype"]) or list(t.shape) != rec["shape"]:
        raise ValueError(f"checkpoint leaf {rec['path']}: file holds "
                         f"{t.dtype} {tuple(t.shape)}, manifest says "
                         f"{rec['dtype']} {tuple(rec['shape'])}")
    return t


def restore(directory: str, step: int | None = None, template: Any = None,
            in_place: bool = False, shardings: Any = None
            ) -> tuple[Any, int]:
    """Load a checkpoint into ``template``'s structure -> (state, step).

    Every template leaf must find a stored leaf of its path, shape and
    dtype (with ``shardings``, the shape of this rank's block of it).
    ``in_place`` copies each into the template's tensor (returning
    ``template``); otherwise each becomes a new tensor on the template
    leaf's device, with its ``requires_grad``."""
    step = latest_step(directory) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {directory}")
    if template is None:
        raise ValueError("restore needs a template tree")
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    recs = {rec["path"]: rec for rec in manifest["leaves"]}
    placed = _by_path(shardings) if shardings is not None else {}

    def one(p, tmpl):
        key = tree.path_str(p)
        t = _load(path, recs[key])
        if key in placed:
            t = shard(t, placed[key]).contiguous()
        if t.shape != tmpl.shape or t.dtype != tmpl.dtype:
            raise ValueError(f"checkpoint leaf {key}: stored {t.dtype} "
                             f"{tuple(t.shape)}, template {tmpl.dtype} "
                             f"{tuple(tmpl.shape)}")
        if in_place:
            with torch.no_grad():
                tmpl.copy_(t)
            return tmpl
        return t.to(tmpl.device).requires_grad_(tmpl.requires_grad)

    out = tree.tree_map_with_path(one, template)
    return (template if in_place else out), step


def _gc(directory: str, keep: int) -> None:
    done = sorted(
        n for n in os.listdir(directory)
        if n.startswith("step_") and not n.endswith(".tmp")
        and os.path.exists(os.path.join(directory, n, "_DONE"))
    )
    for n in done[:-keep]:
        shutil.rmtree(os.path.join(directory, n))
