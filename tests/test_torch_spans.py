"""The port's spans and depth counters (``utils/profiling.span``,
``pipeline.odometry.DEPTH_RUNS``/``DEPTH_LANES``).

With no profiler active a span is one shared context that records nothing.
Under ``torch.profiler`` (the CPU's here) one batched step records its layers
as nested host events: ``pipeline.step_batch`` holds ``tracker.solve``, which
holds one ``read.lm_active`` per LM iteration of the batch, and
``depth.compute``, which holds one ``read.depth_refine`` per refinement
iteration. The step's results do not depend on the profiler. Sizes are
tests/test_torch_batch.py's (64x96), 3 sequences.
"""

import contextlib

import pytest
import torch

from odometry_torch import config as tc
from odometry_torch.camera.pinhole import Pinhole
from odometry_torch.data.synthetic import drive_trajectory, make_scene, render_stereo
from odometry_torch.depth import estimator as te
from odometry_torch.distributed import sweep as tsw
from odometry_torch.distributed.mesh import sequence_mesh
from odometry_torch.pipeline import odometry as to
from odometry_torch.solvers import robust
from odometry_torch.utils import profiling as tp
from odometry_torch.utils.batch import tree_map
from tests.test_torch_batch import _configs
from tests.torch_tools_reference import one_torch_thread  # noqa: F401 (autouse)

CFG = _configs(tc)
LAZY = _configs(tc, depth_every_frame=False, keyframe=dict(motion_threshold=0.02))
LANES = 3


@pytest.fixture(scope="module")
def frames():
    """(left, right) of frames 0 and 1, each (LANES, H, W): scene s along
    drive_trajectory(seed=s), rendered by the port on the CPU."""
    c = CFG.camera
    cam = Pinhole.create(c.fx, c.fy, c.cx, c.cy)
    pairs = [[render_stereo(make_scene(s, depth=14.0, device="cpu"), cam, c.baseline, T,
                            c.height, c.width)[:2]
              for T in drive_trajectory(2, step=0.35, seed=s)] for s in range(LANES)]
    return [tuple(torch.stack([p[i][k] for p in pairs]) for k in range(2)) for i in range(2)]


def _spans(prof) -> list:
    """(name, start_ns, end_ns) of the program's spans in a finished trace."""
    return [(e.name(), e.start_ns(), e.end_ns()) for e in prof.profiler.kineto_results.events()
            if e.name().startswith(("sweep.", "pipeline.", "tracker.", "depth.", "read."))]


def _inside(inner, outer) -> bool:
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def _traced(fn):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, _spans(prof)


def test_span_without_a_profiler_is_the_shared_no_op():
    assert tp.span("tracker.solve") is tp.span("read.lm_active")
    assert isinstance(tp.span("x"), contextlib.nullcontext)
    with tp.span("tracker.solve") as entered:
        assert entered is None


def test_span_under_the_profiler_is_one_host_event():
    def nested():
        with tp.span("tracker.solve"):
            with tp.span("read.lm_active"):
                torch.ones(3).sum()

    _, got = _traced(nested)
    assert [n for n, *_ in got] == ["tracker.solve", "read.lm_active"]
    assert _inside(got[1], got[0])
    # Off again once the session ends.
    assert tp.span("tracker.solve") is tp.span("read.lm_active")


def test_one_step_nests_its_layers_and_counts_its_reads(frames):
    (l0, r0), (l1, r1) = frames
    mesh = sequence_mesh(1, device="cpu")
    states = tsw.batched_init(l0, r0, CFG, mesh)
    (_, outs, _), spans = _traced(lambda: tsw.batched_step(states, l1, r1, CFG, mesh))
    by = lambda name: [s for s in spans if s[0] == name]
    (outer,), (step,), (solve,), (depth,) = (by("sweep.batched_step"), by("pipeline.step_batch"),
                                            by("tracker.solve"), by("depth.compute"))
    assert _inside(step, outer) and _inside(solve, step) and _inside(depth, step)
    assert all(_inside(r, solve) for r in by("read.lm_active"))
    assert all(_inside(r, depth) for r in by("read.depth_refine"))
    lm = sum(int(st.iters.max()) for st in outs[0].track_stats)
    assert len(by("read.lm_active")) == lm > 0
    dres = te.compute_depth(l1, r1, CFG.camera, CFG.depth)
    assert len(by("read.depth_refine")) == int(dres.iters.max()) > 0
    assert not by("read.depth_candidates")  # depth on every frame: no mask read


def test_a_step_is_bit_identical_with_the_profiler_on(frames):
    (l0, r0), (l1, r1) = frames
    state, _ = to.init_batch(l0, r0, CFG, device="cpu")
    plain = to.step_batch(state, l1, r1, CFG)
    traced, spans = _traced(lambda: to.step_batch(state, l1, r1, CFG))
    assert spans
    same = []
    tree_map(lambda a, b: same.append(torch.equal(a, b)), plain, traced)
    assert same and all(same)


def test_depth_counters_count_the_lazy_sub_batch_and_not_the_init(frames):
    """Lanes 1 and 2 repeat frame 0 (no motion, no keyframe candidate), lane
    0 moves past the threshold: one depth run on one lane."""
    (l0, r0), (l1, r1) = frames
    keep = torch.tensor([True, False, False])[:, None, None]
    l1, r1 = torch.where(keep, l1, l0), torch.where(keep, r1, r0)
    runs, lanes = to.DEPTH_RUNS, to.DEPTH_LANES
    state, _ = to.init_batch(l0, r0, LAZY, device="cpu")
    assert (to.DEPTH_RUNS, to.DEPTH_LANES) == (runs, lanes)
    (_, out), spans = _traced(lambda: to.step_batch(state, l1, r1, LAZY))
    assert out.promoted.tolist() == [True, False, False]
    assert (to.DEPTH_RUNS - runs, to.DEPTH_LANES - lanes) == (1, 1)
    assert [n for n, *_ in spans].count("read.depth_candidates") == 1
    to.step_batch(state, l0, r0, LAZY)  # no lane moves: no run
    assert (to.DEPTH_RUNS - runs, to.DEPTH_LANES - lanes) == (1, 1)
    to.step_batch(state, l1, r1, CFG)  # depth on every frame: a run of every lane
    assert (to.DEPTH_RUNS - runs, to.DEPTH_LANES - lanes) == (2, 1 + LANES)


def test_tdist_scale_reads_once_an_iteration():
    r = torch.randn(2, 500, generator=torch.Generator().manual_seed(0)) * 7.0
    valid = torch.ones_like(r, dtype=torch.bool)
    plain = robust.tdist_scale(r, valid, batch_dims=1, max_iters=50)
    traced, spans = _traced(lambda: robust.tdist_scale(r, valid, batch_dims=1, max_iters=50))
    assert torch.equal(plain, traced)
    # One read before each iteration, and one more that stops the loop
    # short of max_iters.
    names = [n for n, *_ in spans]
    assert names == ["read.tdist_scale"] * len(names) and 1 < len(names) < 50


def test_stage_timer_stage_is_a_span_and_its_report_is_unchanged():
    timer = tp.StageTimer()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with timer.stage("step", result=torch.ones(2)):
            torch.ones(3).sum()
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    assert names.count("step") == 1
    with timer.stage("step"):
        pass
    rep = timer.report()
    assert list(rep) == ["step"] and rep["step"]["count"] == 2
    assert set(rep["step"]) == {"total_s", "count", "mean_ms"}
