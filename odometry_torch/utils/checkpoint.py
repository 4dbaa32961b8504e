"""Checkpoint/resume for odometry state and trajectories (port of
``utils/checkpoint.py``).

Any tree of the port's structures round-trips through one .npz file: frozen
dataclasses (``OdometryState``, ``KeyframeStore``), NamedTuples, tuples,
lists, dicts, tensors and numpy arrays. The file layout is the reference's,
key for key: ``f"{i:05d}|{path}"``, where `path` joins dict keys, dataclass
and NamedTuple field names and tuple indices with "/", leaves in the
reference's order (dict keys sorted, fields in declaration order; ``None``
holds no leaf). So a checkpoint written by either package loads in the
other.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any

import numpy as np
import torch


def _children(tree):
    """[(path part, child), ...] of a container, or None for a leaf."""
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [(f.name, getattr(tree, f.name)) for f in dataclasses.fields(tree)]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return list(zip(tree._fields, tree))
    if isinstance(tree, (tuple, list)):
        return [(str(i), v) for i, v in enumerate(tree)]
    return None


def _flatten(tree, path=()):
    """[(key path, leaf), ...] in the reference's leaf order."""
    if tree is None:
        return []
    kids = _children(tree)
    if kids is None:
        return [("/".join(path), tree)]
    return [item for name, child in kids for item in _flatten(child, path + (name,))]


def _rebuild(tree, leaves):
    """`tree`'s structure with its leaves taken in order from the iterator `leaves`."""
    if tree is None:
        return None
    kids = _children(tree)
    if kids is None:
        return next(leaves)
    vals = [_rebuild(child, leaves) for _, child in kids]
    if isinstance(tree, dict):
        return dict(zip(sorted(tree), vals))
    if dataclasses.is_dataclass(tree):
        return type(tree)(**{f.name: v for f, v in zip(dataclasses.fields(tree), vals)})
    if hasattr(tree, "_fields"):
        return type(tree)(*vals)
    return type(tree)(vals)


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save_pytree(path: str, tree: Any) -> None:
    """Save a tree of arrays to one .npz (atomic rename)."""
    payload = {f"{i:05d}|{key}": _to_numpy(leaf)
               for i, (key, leaf) in enumerate(_flatten(tree))}
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp.npz"
    np.savez(tmp, **payload)
    os.replace(tmp, path)


def load_pytree(path: str, like: Any) -> Any:
    """Restore a tree saved by save_pytree, using `like` for structure.

    A tensor leaf of `like` comes back as a tensor on its device with its
    dtype; any other leaf comes back as the file's numpy array. The leaf
    count, and the shape of every template leaf that has one, must match
    (ValueError otherwise).
    """
    with np.load(path) as data:
        keys = sorted(data.files, key=lambda k: int(k.split("|")[0]))
        arrays = [data[k] for k in keys]
    like_leaves = [leaf for _, leaf in _flatten(like)]
    if len(like_leaves) != len(arrays):
        raise ValueError(
            f"checkpoint has {len(arrays)} leaves but template expects {len(like_leaves)}")
    out = []
    for arr, tmpl in zip(arrays, like_leaves):
        if hasattr(tmpl, "shape") and tuple(tmpl.shape) != tuple(arr.shape):
            raise ValueError(f"shape mismatch: checkpoint {arr.shape} vs template "
                             f"{tuple(tmpl.shape)}")
        if isinstance(tmpl, torch.Tensor):
            arr = torch.as_tensor(arr, device=tmpl.device).to(tmpl.dtype)
        out.append(arr)
    return _rebuild(like, iter(out))
