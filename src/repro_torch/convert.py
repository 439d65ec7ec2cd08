"""Trees of tensors: a ``tree_map`` over the port's params / cache trees,
and :func:`from_numpy_tree`, which carries a reference params or
serving-params tree, or an ``LCState`` (w_c, λ, Θ per path, μ, lc_iter),
after ``np.asarray`` on each leaf, into the port.

A tree is nested dicts, tuples, lists and NamedTuples; its leaves are
tensors (arrays) or static metadata such as a ``PackedLayout``, which
passes through unchanged.
"""
from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core.compression import PackedLayout

_LAYOUT_FIELDS = ("kd", "n", "k", "bits", "lanes", "shape", "dtype", "order")


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_map(fn: Callable[[torch.Tensor], Any], tree):
    """Apply ``fn`` to every tensor leaf; other leaves pass through."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map(fn, v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return tree


def tree_leaves(tree) -> list:
    """Tensor leaves in a fixed (insertion) order."""
    out = []
    tree_map(out.append, tree)
    return out


def _to_tensor(arr: np.ndarray, device) -> torch.Tensor:
    if arr.dtype.name == "bfloat16":          # ml_dtypes' numpy bfloat16
        t = torch.from_numpy(np.array(arr, copy=True).view(np.uint16))
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(arr, copy=True)).to(device)


def from_numpy_tree(tree, device=None):
    """Reference tree (numpy leaves) → port tree (torch leaves on
    ``device``).  A reference ``PackedLayout`` becomes the port's by its
    fields (duck-typed); a reference ``KVCache`` or ``LCState`` becomes the
    port's; other NamedTuples become plain tuples."""
    if isinstance(tree, (np.ndarray, np.generic)):
        return _to_tensor(np.asarray(tree), device)
    if isinstance(tree, dict):
        return {k: from_numpy_tree(v, device) for k, v in tree.items()}
    if all(hasattr(tree, f) for f in _LAYOUT_FIELDS):
        return PackedLayout(**{f: getattr(tree, f) for f in _LAYOUT_FIELDS})
    if _is_namedtuple(tree):
        children = [from_numpy_tree(v, device) for v in tree]
        if type(tree).__name__ == "KVCache" and tree._fields == ("k", "v"):
            from repro_torch.models.attention import KVCache
            return KVCache(*children)
        if type(tree).__name__ == "LCState":
            from repro_torch.core.lc import LCState
            if tree._fields == LCState._fields:
                return LCState(*children)
        return tuple(children)
    if isinstance(tree, (tuple, list)):
        return type(tree)(from_numpy_tree(v, device) for v in tree)
    return tree
