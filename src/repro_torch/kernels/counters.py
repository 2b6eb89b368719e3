"""The kernel wrappers' launch and plain-call counters, read and advanced as
one set.

Each wrapper counts in a Python attribute: ``<wrapper>.launches``,
``matmul.splitk_launches``, ``grouped_matmul.body_launches[body]`` and
``<plain>.calls``.  A CUDA graph replay runs no Python, so these tick only
while a graph is captured.  The serve engine takes a ``snapshot()`` before
its capture, keeps the ``delta`` the capture made, puts the counters back
(the capture launched nothing) and ``advance``\\ s them by that delta after
every replay: the counters keep counting launches on the card.
"""
from __future__ import annotations

import functools
import importlib

_MODULES = ("decode_attention.decode_attention",
            "flash_attention.flash_attention", "fused_norm.fused_norm",
            "ssd.ssd", "moe_gmm.moe_gmm", "matmul.matmul")
_FIELDS = ("launches", "splitk_launches", "calls")


@functools.cache
def _counted():
    """{name: (function, field, body)} for every counter; ``body`` is None
    for an int attribute, else the key in the function's body dict."""
    out = {}
    for mod_name in _MODULES:
        mod = importlib.import_module(f"repro_torch.kernels.{mod_name}")
        for fn in vars(mod).values():
            if (not callable(fn)
                    or getattr(fn, "__module__", "") != mod.__name__):
                continue
            base = fn.__name__
            for field in _FIELDS:
                if isinstance(getattr(fn, field, None), int):
                    out[f"{base}.{field}"] = (fn, field, None)
            for body in getattr(fn, "body_launches", None) or {}:
                out[f"{base}.body_launches[{body}]"] = (fn, "body_launches",
                                                        body)
    return out


def _get(fn, field, body) -> int:
    return getattr(fn, field) if body is None else getattr(fn, field)[body]


def _set(fn, field, body, value: int) -> None:
    if body is None:
        setattr(fn, field, value)
    else:
        getattr(fn, field)[body] = value


def snapshot() -> dict[str, int]:
    """Every counter's value, by name."""
    return {name: _get(*c) for name, c in _counted().items()}


def delta(after: dict[str, int], before: dict[str, int]) -> dict[str, int]:
    """The counters that moved between two snapshots, and by how much."""
    return {k: after[k] - before.get(k, 0) for k in after
            if after[k] != before.get(k, 0)}


def restore(snap: dict[str, int]) -> None:
    """Set every counter named in ``snap`` to its value there."""
    for name, c in _counted().items():
        if name in snap:
            _set(*c, snap[name])


def advance(moved: dict[str, int]) -> None:
    """Add ``moved`` (a ``delta``) to the counters."""
    counted = _counted()
    for name, n in moved.items():
        fn, field, body = counted[name]
        _set(fn, field, body, _get(fn, field, body) + n)


def launches(moved: dict[str, int]) -> int:
    """Kernel launches in a delta: the wrappers' ``launches`` and
    ``splitk_launches`` (``body_launches`` splits the same launches, and
    plain calls launch nothing)."""
    return sum(n for name, n in moved.items()
               if name.endswith((".launches", ".splitk_launches")))
