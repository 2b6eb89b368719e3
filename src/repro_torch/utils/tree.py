"""Small tree helpers over the port's parameter and state trees (the port
of ``repro.utils.tree``).

A tree is nested dicts and lists of tensors: the port keeps a model's
layers as per-layer lists where the reference stacks them on leading axes
(``convert._unstack``).  :func:`leaves_with_paths` defines the leaf order
once for every consumer (the optimizer, checkpoints, the tests): dict keys
sorted, as ``jax.tree_util`` orders them, list entries by index.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator

import torch

Path = tuple  # of str (dict keys) and int (list indices)


def leaves_with_paths(tree: Any, prefix: Path = ()) -> Iterator[
        tuple[Path, Any]]:
    """Every leaf with its path, in the one order the port uses."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from leaves_with_paths(tree[key], prefix + (key,))
    elif isinstance(tree, (list, tuple)):
        for i, sub in enumerate(tree):
            yield from leaves_with_paths(sub, prefix + (i,))
    else:
        yield prefix, tree


def leaves(tree: Any) -> list:
    return [leaf for _, leaf in leaves_with_paths(tree)]


def path_str(path: Path) -> str:
    """``("params", "layers", 0, "attn", "wq")`` -> ``params/layers/0/attn/wq``
    (the reference checkpoint's key for the same leaf, its stacked layers
    aside)."""
    return "/".join(str(k) for k in path)


def stacked_axes(path: Path) -> int:
    """How many leading axes the reference stacks above this leaf: one for
    each list index on its path (``layers[i]`` one, the VLM's
    ``self_layers[g][j]`` two)."""
    return sum(isinstance(k, int) for k in path)


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``), keeping the structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_map_with_path(fn: Callable, tree: Any, prefix: Path = ()) -> Any:
    """``tree``'s structure with each leaf replaced by ``fn(path, leaf)``."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, prefix + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, v, prefix + (i,))
                          for i, v in enumerate(tree))
    return fn(prefix, tree)


def tree_param_count(tree: Any) -> int:
    return sum(x.numel() for x in leaves(tree))


def tree_bytes(tree: Any) -> int:
    return sum(x.numel() * x.element_size() for x in leaves(tree))


def tree_zeros_like(tree: Any, dtype: torch.dtype | None = None) -> Any:
    return tree_map(lambda x: torch.zeros_like(x, dtype=dtype or x.dtype,
                                               requires_grad=False), tree)
