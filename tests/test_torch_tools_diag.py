"""The port's run diagnostics against the reference's: ``diag_divergence``,
``diag_basin``, ``bisect_fast_robustness`` and ``verify_loop_closure``'s
trajectory builder.

The reference tools run at 376x1241 in ``main`` or at import, so their
quantities are computed here through the reference's public API
(``run_sequence`` with a ``progress`` callback, ``init``,
``gaussian_image_pyramid``, ``solve_pose_points``) on the frames the port's
tool renders (144x320), as the reference tool computes them. The runs track
with the bilinear sampler: fast_config's "mm" sampler parts two float32
implementations' LM paths (ROADMAP C1; its runs are held in
tests/test_torch_tools_bench.py). Iteration counts, flags, keyframes and
survivors are held equal, poses and translation errors within C1's 5e-4 and
costs within a relative 5e-4.
"""

import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from odometry_tpu.camera import Pinhole as JPinhole
from odometry_tpu.eval.metrics import mean_translation_error as j_mte
from odometry_tpu.image.pyramid import gaussian_image_pyramid as j_pyramid
from odometry_tpu.mapping.loop_closure import LoopClosureConfig as JLoopClosureConfig
from odometry_tpu.pipeline.odometry import init as j_init
from odometry_tpu.pipeline.runner import run_sequence as j_run_sequence
from odometry_tpu.tracking.tracker import solve_pose_points as j_solve_pose_points
from odometry_torch.tools import bisect_fast_robustness as bis
from odometry_torch.tools import diag_basin, diag_divergence, verify_loop_closure
from odometry_torch.tools.diag_divergence import render_family
from tests.torch_tools_reference import as_numpy, port_config, reference_config, same_fields
from tests.torch_tools_reference import one_torch_thread  # noqa: F401 (autouse)

FRAMES = 4
H, W = 144, 320
ATOL = 5e-4  # ROADMAP C1
COST_RTOL = 5e-4
REPO = Path(__file__).resolve().parents[1]


def _render_once(monkeypatch, module, scene, seed, cfg, num_frames):
    """The tool's frames, rendered once for the tool and the reference."""
    out = render_family(scene, seed, cfg, num_frames, device="cpu")
    monkeypatch.setattr(module, "render_family", lambda *a, **k: out)
    return out


def _bilinear(cfg):
    return dataclasses.replace(cfg, tracker=dataclasses.replace(cfg.tracker, interp="bilinear"))


def test_divergence_rows_match_the_reference(monkeypatch):
    """fast_config with the bilinear tracker (bisect's "tracker-bilinear",
    compiled once for both tests) on C12's plane seed 4."""
    cfg_t, cfg_j = _bilinear(port_config("fast", H, W)), _bilinear(reference_config("fast", H, W))
    preset, scene = "fast", "plane"
    poses, rendered = _render_once(monkeypatch, diag_divergence, scene, 4, cfg_t, FRAMES)
    got = diag_divergence.divergence(cfg_t, scene, 4, FRAMES, device="cpu")
    rows = []

    def progress(i, out):  # tools/diag_divergence.py:64-78
        stats = out.track_stats[-1]
        rows.append(dict(frame=i, P=np.asarray(out.cur_pose), motion=float(out.motion),
                         promoted=bool(out.promoted), lost=bool(out.lost),
                         err_final=float(stats.err_final), err_first=float(stats.err_first),
                         iters=int(stats.iters), nvd=int(out.num_valid_depth)))

    res = j_run_sequence(as_numpy(rendered), cfg_j, progress=progress)
    assert len(got["rows"]) == len(rows) == FRAMES - 1
    for g, r in zip(got["rows"], rows):
        for key in ("frame", "promoted", "lost", "nvd", "iters"):
            assert g[key] == r[key], (key, g, r)
        err = float(np.linalg.norm(r["P"][:3, 3] - poses[r["frame"]][:3, 3]))
        assert g["err"] == pytest.approx(err, abs=ATOL)
        assert g["motion"] == pytest.approx(r["motion"], abs=ATOL)
        for key in ("err_first", "err_final"):
            assert g[key] == pytest.approx(r[key], rel=COST_RTOL, abs=ATOL)
    assert got["mte"] == pytest.approx(j_mte(poses[: res.num_frames], res.poses), abs=ATOL)
    assert got["keyframes"] == len(res.keyframe_ids) and got["lost"] == len(res.lost_ids)
    lines = diag_divergence.format_run(preset, scene, 4, got)
    assert lines[0] == f"=== {preset}/{scene} seed 4 ===" and lines[-1].startswith("  => mte ")
    assert lines[1].startswith("  f01 ") and " err0 " in lines[1] and " nvd " in lines[1]


def test_basin_levels_match_the_reference(monkeypatch):
    base_t, base_j = port_config("fast", H, W), reference_config("fast", H, W)
    variants = [v for v in diag_basin.VARIANTS if v[0] == "bilinear"]
    poses, rendered = _render_once(monkeypatch, diag_basin, "plane", 11, base_t, 2)
    got = diag_basin.basin(base_t, 11, "plane", variants, device="cpu")
    (l0, r0), (l1, _) = as_numpy(rendered[:2])
    c = base_j.camera
    cam = JPinhole.create(c.fx, c.fy, c.cx, c.cy)
    # tools/diag_basin.py:55-57,80-100.
    T_gt = np.asarray(jnp.matmul(jnp.linalg.inv(jnp.asarray(poses[1])), jnp.asarray(poses[0])))
    ref = []
    for vname, replace in (("bilinear", {"interp": "bilinear"}),):
        tcfg = dataclasses.replace(base_j.tracker, **replace)
        cfg = dataclasses.replace(base_j, tracker=tcfg)
        state, _ = jax.jit(lambda l, r: j_init(l, r, cfg, None))(l0, r0)
        pyr1 = j_pyramid(jnp.asarray(l1), tcfg.num_levels, smooth=True)
        for init_name, T0 in (("identity", np.eye(4, dtype=np.float32)), ("gt", T_gt)):
            res = jax.jit(lambda kf, T: j_solve_pose_points(kf, pyr1, cam, tcfg, T))(
                state.kf_track, jnp.asarray(T0))
            T = np.asarray(res.T)
            ref.append((vname, init_name, float(np.linalg.norm(T[:3, 3] - T_gt[:3, 3])),
                        [(float(s.err_first), float(s.err_final), int(s.iters))
                         for s in res.stats]))
    assert [(g["variant"], g["init"]) for g in got] == [(v, i) for v, i, _, _ in ref]
    for g, (_, _, terr, levels) in zip(got, ref):
        assert g["terr"] == pytest.approx(terr, abs=ATOL)
        assert [it for _, _, it in g["levels"]] == [it for _, _, it in levels]
        np.testing.assert_allclose([lv[:2] for lv in g["levels"]], [lv[:2] for lv in levels],
                                   rtol=COST_RTOL, atol=ATOL)
    line = diag_basin.format_row(got[0])
    assert line.startswith("bilinear         identity terr ") and "  L3:" in line
    # The reference's seven variants (tools/diag_basin.py:59-73), in order.
    assert [v for v, _ in diag_basin.VARIANTS] == [
        "fast-asis", "bilinear", "cap16k", "prec.995", "iters20", "bilin+cap16k",
        "cap16k+prec+it"]


def test_bisect_rows_match_the_reference(monkeypatch):
    base_t, base_j = port_config("fast", H, W), reference_config("fast", H, W)
    variants = [v for v in bis.VARIANTS if v[0] == "tracker-bilinear"]
    # tools/bisect_fast_robustness.py:30-45: each knob of the reference's list.
    knobs = {
        "fast(asis)": lambda c: c,
        "tracker-bilinear": lambda c: dataclasses.replace(
            c, tracker=dataclasses.replace(c.tracker, interp="bilinear")),
        "no-step-tol": lambda c: dataclasses.replace(
            c, tracker=dataclasses.replace(c.tracker, step_tol=0.0)),
        "caps-8k-16k": lambda c: dataclasses.replace(
            c, tracker=dataclasses.replace(c.tracker, point_capacity=8192),
            depth=dataclasses.replace(c.depth, max_residuals=16384)),
        "depth-bilinear": lambda c: dataclasses.replace(
            c, depth=dataclasses.replace(c.depth, interp="bilinear")),
        "eager-depth": lambda c: dataclasses.replace(c, depth_every_frame=True),
    }
    assert [name for name, _ in bis.VARIANTS] == list(knobs)
    for name, mod in bis.VARIANTS:
        assert same_fields(mod(base_t), knobs[name](base_j))
    assert bis.CASES == [("plane11", "plane", 11), ("drive4", "driving", 4)]
    cases = bis.CASES[:1]
    poses, rendered = _render_once(monkeypatch, bis, "plane", 11, base_t, FRAMES)
    lines = []
    got = bis.bisect(base_t, variants, cases, FRAMES, device="cpu", log=lines.append)
    frames = as_numpy(rendered)
    for g, (vname, _) in zip(got, variants):
        ref = j_run_sequence(frames, knobs[vname](base_j))
        assert g["error"] is None and g["keyframes"] == len(ref.keyframe_ids)
        assert g["lost"] == len(ref.lost_ids)
        assert g["mte"] == pytest.approx(j_mte(poses[: ref.num_frames], ref.poses), abs=ATOL)
    assert lines[0].startswith("tracker-bilinear   plane11 : mte ")


def test_loop_trajectory_is_the_references_bit_for_bit(monkeypatch):
    """The reference tool's own main, stopped at its first run_slam, gives
    the poses it renders and the arguments it runs with."""
    spec = importlib.util.spec_from_file_location(
        "verify_loop_closure_tpu", REPO / "tools" / "verify_loop_closure_tpu.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    rendered, calls = [], []

    class Stop(Exception):
        pass

    def run_slam(frames, cfg, **kw):
        calls.append((cfg, kw))
        raise Stop

    monkeypatch.setattr(tool, "make_driving_scene", lambda *a, **k: None)
    monkeypatch.setattr(tool, "render_stereo",
                        lambda scene, cam, b, T, H, W: (rendered.append(np.asarray(T)), 0, 0))
    monkeypatch.setattr(tool, "run_slam", run_slam)
    with pytest.raises(Stop):
        tool.main()
    ours = verify_loop_closure.loop_trajectory()
    assert len(ours) == len(rendered) == 49
    for a, b in zip(ours, rendered):
        assert a.dtype == b.dtype == np.float32 and np.array_equal(a, b)
    cfg_j, kw = calls[0]
    assert same_fields(verify_loop_closure.loop_config(), cfg_j)
    assert kw == dict(map_capacity=32, window=4, ba_every=100, loop_closure=False)
    lc = JLoopClosureConfig(radius=1.5, min_separation=3, min_inliers=200)
    assert same_fields(verify_loop_closure.LOOP_CLOSURE, lc)
