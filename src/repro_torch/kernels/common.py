"""Shared helpers for the port's CUDA kernels: shape arithmetic, the masking
sentinel, the page gather, the guard against differentiating a launch,
and the ``nvcc`` build + ``ctypes`` loader.

Kernels are plain-C-interface shared libraries compiled for ``sm_90a`` at
first use into ``build/repro_torch/`` at the repository root (a few seconds
per source; no PyTorch headers are included).  Nothing here compiles or
loads anything at import time, so every module imports on a machine with
no CUDA toolkit.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

import torch

NEG_INF = -1e30     # the same finite sentinel as the reference's kernels

_REPO_ROOT = pathlib.Path(__file__).resolve().parents[3]
BUILD_DIR = _REPO_ROOT / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo")

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def gather_pages(pool, pages):
    """(N, page_size, ...) pool + (b, P) table -> dense (b, P*page_size, ...).
    Unmapped entries clamp to page 0; their rows are masked by the caller's
    ``kv_len``.  The paged kernels' addressing, as a copy: the gather arm
    of the model and the plain paged versions read it."""
    N, psz = pool.shape[0], pool.shape[1]
    b, P = pages.shape
    g = pool[pages.to(pool.device).long().clamp(0, N - 1)]   # (b, P, psz, ...)
    return g.reshape((b, P * psz) + tuple(pool.shape[2:]))


def refuse_grad(name: str, *inputs) -> None:
    """Raise if autograd would have to differentiate this launch.

    A kernel is launched through ``ctypes`` into an output allocated
    beforehand, so its result carries no ``grad_fn``: everything upstream
    of it would silently get no gradient while the loss still fell through
    the residual path.  Every CUDA branch of a kernel wrapper calls this
    first; train on the plain route (``decode_kernel="xla"``, what
    ``train.step.make_train_step`` does) or run the kernel route under
    ``torch.no_grad()``."""
    if torch.is_grad_enabled() and any(
            isinstance(x, torch.Tensor) and x.requires_grad for x in inputs):
        raise RuntimeError(
            f"{name}: an input requires grad, but the CUDA kernel records no "
            f"autograd graph; differentiate the plain route "
            f"(decode_kernel='xla') or call it under torch.no_grad()")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def build_library(source: pathlib.Path) -> pathlib.Path:
    """Compile one ``.cu`` file into ``BUILD_DIR`` (cached by content hash)
    and return the shared library's path."""
    digest = hashlib.sha256(
        source.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    out = BUILD_DIR / f"{source.stem}-{digest}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) for {source.name}:\n"
            f"{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, out)
    return out


def load_library(source: pathlib.Path, bind) -> ctypes.CDLL:
    """Build (once per process) and load ``source``; ``bind(lib)`` declares
    the ``argtypes``/``restype`` of each exported function."""
    key = str(source)
    with _lock:
        lib = _libs.get(key)
        if lib is None:
            lib = ctypes.CDLL(str(build_library(source)))
            bind(lib)
            _libs[key] = lib
    return lib
