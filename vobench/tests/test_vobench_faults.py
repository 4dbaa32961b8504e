"""The check holds: a sound run of the timed path comes out correct, and the
same run with the timed path broken underneath comes out not correct, once
for each fault a one-card sweep can have (a step that returns its state
unchanged; half of the batch left out; an answer altered where it is
produced). The harness's look for a card is skipped: the run is on the CPU
at a small size. The exchange between cards does not exist on one card."""

import dataclasses

import pytest
import torch

from conftest import tiny_cell
from odometry_torch.distributed import sweep
from odometry_torch.utils.batch import tree_map
from vobench import harness


def _run(step_fn=None):
    cell = tiny_cell("ref_sweep", lanes=4, frames=5)
    cell = dataclasses.replace(cell, limits=dict(cell.limits, check={"lanes": 4,
                                                                     "steps_per_lane": 2}))
    return harness.run_cell(cell, 2**31 + 21, 0.5, False, device="cpu", step_fn=step_fn,
                            log=lambda m: None)


def state_unchanged(states, left, right, cfg, mesh):
    _, outs, ok = sweep.batched_step(states, left, right, cfg, mesh)
    return states, outs, ok


def half_the_batch(states, left, right, cfg, mesh):
    """Steps lanes [0, B/2) only; the other lanes get their results."""
    B = left.shape[0]
    h = B // 2
    idx = torch.arange(B) % h
    half = [tree_map(lambda t: t[:h], s) for s in states]
    new, outs, ok = sweep.batched_step(half, left[:h], right[:h], cfg, mesh)
    spread = lambda tree: tree_map(lambda t: t[idx.to(t.device)], tree)
    return [spread(s) for s in new], [spread(o) for o in outs], ok


def answer_altered(states, left, right, cfg, mesh):
    """The tracker's pose moved by 1 cm along x where the step produces it."""
    new, outs, ok = sweep.batched_step(states, left, right, cfg, mesh)
    shift = torch.zeros(4, 4)
    shift[0, 3] = 0.01
    return new, [o._replace(pose_to_kf=o.pose_to_kf + shift) for o in outs], ok


def test_sound_run_is_correct():
    res = _run()
    assert res["correct"], res["compared"]


@pytest.mark.parametrize("fault", [state_unchanged, half_the_batch, answer_altered],
                         ids=lambda f: f.__name__)
def test_broken_timed_path_is_not_correct(fault):
    res = _run(fault)
    assert not res["correct"], res["compared"]
