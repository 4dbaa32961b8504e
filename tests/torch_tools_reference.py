"""Helpers of the ``tests/test_torch_tools_*.py`` and
``test_torch_sweep_default.py`` files: the reference's and the port's presets
at a reduced camera, the port's rendered frames as numpy, so both packages
run on the same inputs, and a fixture that runs a module on one torch
thread."""

import dataclasses

import numpy as np
import pytest
import torch

from odometry_tpu import config as jc
from odometry_torch import config as tc

H, W = 144, 320


def reference_config(name, height=H, width=W):
    """The reference's preset `name` at height x width, as ``tc.at_size``
    builds the port's."""
    cfg = getattr(jc, f"{name}_config")()
    c = cfg.camera
    sx, sy = width / c.width, height / c.height
    cam = dataclasses.replace(c, fx=c.fx * sx, fy=c.fy * sy, cx=c.cx * sx, cy=c.cy * sy,
                              height=height, width=width)
    return jc.adapt_to_camera(dataclasses.replace(cfg, camera=cam))


def port_config(name, height=H, width=W):
    return tc.at_size(getattr(tc, f"{name}_config")(), height, width)


def as_numpy(frames):
    """(left, right[, ...]) tensors -> (left, right) float32 numpy pairs."""
    return [tuple(np.asarray(a.cpu().numpy(), np.float32) for a in f[:2]) for f in frames]


def same_fields(a, b) -> bool:
    """Two packages' configuration dataclasses hold equal values, field by field."""
    return dataclasses.asdict(a) == dataclasses.asdict(b)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU path at these sizes is thousands of small operators:
    under the tier-1 command's six workers, a pool of threads per operator
    only waits for cores. Restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
