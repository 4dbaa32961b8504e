"""Helpers of vobench's tests: a cell cut to a CPU-sized camera, and the card
fixture (tests marked ``cuda`` decide in it whether there is a card)."""

import dataclasses
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def tiny_cell(name: str, H: int = 48, W: int = 160, lanes: int = 3, frames: int = 6):
    """Cell `name` with its camera cut to H x W (``config.at_size``), `lanes`
    lanes and `frames` frames a sweep: the run path at a size the CPU holds."""
    from odometry_torch import config as port_config

    from vobench import harness

    cell = harness.load_cell(name)
    cfg = port_config.at_size(harness.build_config(port_config, cell.config["pipeline"]), H, W)
    conf = dict(cell.config, pipeline=dataclasses.asdict(cfg), sequence_frames=frames)
    traffic = dict(cell.traffic, lane_seeds=[0, lanes], warmup_steps=1, trace_steps=2)
    return dataclasses.replace(cell, config=conf, traffic=traffic)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Small operators run faster on one thread, beside other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"
