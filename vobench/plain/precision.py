"""The plain reference's precision: float32, or the control's bfloat16.

Inside :func:`low_precision` every image-sized tensor of the reference (the
blurred images and pyramid levels, the gradients, every sampled value and
every SSD operand and partial sum) is rounded to bfloat16 after the operation
that makes it, as a bfloat16 computation stores it; poses, the 6x6 systems and
the solvers stay float32. That is the step a later change would be tempted to
take (half the bytes of every per-pixel pass), and the benchmark's control.
"""

from __future__ import annotations

import contextlib

import torch

_LOW = [False]


def q(t: torch.Tensor) -> torch.Tensor:
    """`t`, rounded to bfloat16 and back inside :func:`low_precision`."""
    if _LOW[0] and t.is_floating_point():
        return t.to(torch.bfloat16).to(t.dtype)
    return t


@contextlib.contextmanager
def low_precision(on: bool = True):
    """Run the block with the reference's image-sized tensors in bfloat16."""
    old = _LOW[0]
    _LOW[0] = on
    try:
        yield
    finally:
        _LOW[0] = old
