"""Leading batch axes on trees of tensors.

The frontend, the tracker and the pipeline compute on a batch of sequences
at once (the counterpart of the reference's ``jax.vmap``): every tensor of a
state or a result leads with the batch axis. An unbatched call is the batch
of one: :func:`batch_of_one` adds the axis to the inputs and
:func:`lane` takes lane 0 of the outputs, as views.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def tree_map(fn, *trees):
    """Apply `fn` leafwise over matching tensors (or numpy arrays), tuples,
    NamedTuples and dataclasses; None and other leaves pass through from the
    first tree."""
    t0 = trees[0]
    if isinstance(t0, (torch.Tensor, np.ndarray)):
        return fn(*trees)
    if dataclasses.is_dataclass(t0) and not isinstance(t0, type):
        return type(t0)(**{f.name: tree_map(fn, *(getattr(t, f.name) for t in trees))
                           for f in dataclasses.fields(t0)})
    if isinstance(t0, tuple):
        out = [tree_map(fn, *leaves) for leaves in zip(*trees)]
        return type(t0)(*out) if hasattr(t0, "_fields") else type(t0)(out)
    return t0


def lane(tree, i: int):
    """Lane `i` of every tensor of `tree` (views)."""
    return tree_map(lambda t: t[i], tree)


def batch_of_one(tree):
    """`tree` with a leading batch axis of 1 on every tensor (views)."""
    return tree_map(lambda t: t[None], tree)


def batch_size(tree) -> int:
    """The leading axis of the first tensor of `tree`."""
    found = []
    tree_map(lambda t: found.append(t.shape[0]), tree)
    return found[0]


def one_lane_unbatched(fn):
    """`fn` over tensors (or trees) that lead with a batch axis, computed on
    lane 0 alone when the batch has one lane, the axis given back after.

    Small products round differently batched than alone: a (1, 4, 4) pose
    product (a batched matmul) and a (4, 4) one (a plain matmul), or the 6x6
    normal equations as (1, 6, N) x (1, N, 6) against (6, N) x (N, 6) and a
    matrix-vector product, go through different BLAS and cuBLAS kernels. So
    the batch of one (``pipeline.odometry.step`` on one sequence) takes the
    unbatched products and gives the bits of the unbatched code; a lane of a
    larger batch agrees with its own run to float32 rounding.
    """

    def wrapped(*args):
        if batch_size(args) == 1:
            return batch_of_one(fn(*lane(args, 0)))
        return fn(*args)

    wrapped.__name__ = getattr(fn, "__name__", "wrapped")
    wrapped.__doc__ = fn.__doc__
    return wrapped
