"""``odometry_torch.tools.accuracy_sweep`` against the reference's
``tools/accuracy_sweep.py``.

The aggregation (median, min, max, green count, margins, exit code, inf on
a failed run) is checked on given mtes. Then one seed of each (preset,
family) at a reduced camera (96x320, intrinsics in proportion, through
each package's ``adapt_to_camera``) and a few frames: each package renders
the family's frames from the same seed (the reference's loop,
``tools/accuracy_sweep.py:57-100``), runs its own ``run_sequence``, and the
trajectories agree within ``tests/test_torch_pipeline.py``'s tolerances
(:87 for accurate_config's bilinear tracker, :96 for fast_config's "mm").
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from odometry_tpu import config as jc
from odometry_tpu.camera import Pinhole as JPinhole
from odometry_tpu.data import synthetic as js
from odometry_tpu.pipeline.runner import run_sequence as j_run_sequence
from odometry_torch import config as tc
from odometry_torch.tools import accuracy_sweep as acc

H, W, FRAMES, SEED = 96, 320, 4, 3


def _record(config, scene, seed, mte):
    return dict(config=config, scene=scene, seed=seed, mte=mte, error=None, poses=None,
                frames=FRAMES, failed_at=None, keyframes=1, lost=0, depth_runs=1, seconds=0.1,
                b1=0, b2=0)


def test_summarize_matches_the_references_aggregation():
    mtes = {("fast", "plane"): [0.02, 0.05, 0.03, 0.2, 0.04],
            ("fast", "textured"): [0.1, float("inf"), 0.12, 0.14, 0.16],
            ("accurate", "driving"): [0.11, 0.2, 0.12, 0.01, 0.3]}
    records = [_record(c, f, s, m) for (c, f), ms in mtes.items()
               for s, m in zip(acc.SEEDS, ms)]
    rows = acc.summarize(records)
    assert [(r["config"], r["scene"]) for r in rows] == list(mtes)
    for r, ms in zip(rows, mtes.values()):
        m = np.asarray(ms)
        # tools/accuracy_sweep.py:111-121,143-144.
        assert r["median"] == float(np.median(m)) and r["min"] == float(m.min())
        assert r["max"] == float(m.max()) and r["n"] == len(m)
        assert r["n_green"] == int((m < acc.GATE).sum())
    assert [r["ok"] for r in rows] == [True, True, False]  # 0.04 <= 0.105; 0.14 <= 0.15; 0.12
    assert rows[1]["max"] == float("inf") and rows[1]["n_green"] == 3
    assert (acc.SEEDS, acc.GATE, acc.MARGIN) == ([3, 4, 5, 11, 23], 0.15, 0.30)
    assert acc.FAMILY_MARGIN == {"plane": 0.30, "driving": 0.30, "textured": 0.0}


@pytest.mark.parametrize("mte, rc", [(0.05, 0), (0.11, 1), (float("inf"), 1)])
def test_main_exit_code_and_report(monkeypatch, tmp_path, mte, rc):
    records = [_record("fast", "plane", s, mte) for s in (3, 4, 5)]
    monkeypatch.setattr(acc, "sweep", lambda *a, **k: records)
    out = tmp_path / "accuracy.md"
    assert acc.main(["--device", "cpu", "--configs", "fast", "--families", "plane",
                     "--seeds", "3", "4", "5", "--out", str(out)]) == rc
    text = out.read_text()
    assert f"| fast | plane | {mte:.4f} |" in text and "Measured on: cpu (host)" in text


def test_default_out_is_not_the_references_table(tmp_path):
    assert acc.DEFAULT_OUT.name != "ACCURACY.md"
    assert acc.DEFAULT_OUT.parts[-3:] == ("build", "odometry_torch", "accuracy.md")
    with pytest.raises(SystemExit):
        acc.main(["--device", "cpu", "--out", str(tmp_path / "ACCURACY.md")])
    assert not (tmp_path / "ACCURACY.md").exists()


def test_a_failed_init_counts_as_inf():
    cfg = tc.at_size(tc.fast_config(), H, W)
    flat = [(np.zeros((H, W), np.float32), np.zeros((H, W), np.float32))] * 2
    rec = acc.run_one(cfg, np.stack([np.eye(4)] * 2), flat, "cpu")
    assert rec["mte"] == float("inf") and "Init" in rec["error"]
    assert acc.summarize([dict(config="fast", scene="plane", seed=3, **rec)])[0]["ok"] is False


def _reference_config(name, H=H, W=W):
    """The reference's preset at H x W as tc.at_size builds the port's."""
    cfg = getattr(jc, f"{name}_config")()
    c = cfg.camera
    sx, sy = W / c.width, H / c.height
    cam = dataclasses.replace(c, fx=c.fx * sx, fy=c.fy * sy, cx=c.cx * sx, cy=c.cy * sy,
                              height=H, width=W)
    return jc.adapt_to_camera(dataclasses.replace(cfg, camera=cam))


def _reference_frames(family, cfg):
    """tools/accuracy_sweep.py's scene families and render loop (:57-100)."""
    scene = {"plane": lambda s: js.make_scene(s, depth=14.0),
             "driving": lambda s: js.make_driving_scene(s, side_x=20.0, wall_z=26.0),
             "textured": lambda s: js.make_natural_scene(s, depth=14.0)}[family](SEED)
    nu = js.PhotometricNuisance(seed=SEED) if family == "textured" else None
    c = cfg.camera
    cam = JPinhole.create(c.fx, c.fy, c.cx, c.cy)
    render = jax.jit(lambda T: js.render_stereo(scene, cam, c.baseline, T, H, W))
    poses = js.drive_trajectory(FRAMES, step=0.25, seed=SEED)
    frames = []
    for fi, T in enumerate(poses):
        left, right, _ = render(jnp.asarray(T))
        if nu is not None:
            left = js.apply_nuisance(np.asarray(left), fi, nu, eye=0)
            right = js.apply_nuisance(np.asarray(right), fi, nu, eye=1)
        frames.append((np.asarray(left), np.asarray(right)))
    return poses, frames


@pytest.fixture(scope="module")
def port_records():
    return {(r["config"], r["scene"]): r for r in
            acc.sweep(seeds=[SEED], frames=FRAMES, device="cpu", height=H, width=W, log=None)}


@pytest.mark.parametrize("family", acc.FAMILIES)
@pytest.mark.parametrize("preset", list(acc.CONFIGS))
def test_sweep_runs_match_the_reference(port_records, preset, family):
    cfg = _reference_config(preset)
    poses, frames = _reference_frames(family, cfg)
    ref = j_run_sequence(frames, cfg)
    got = port_records[(preset, family)]
    assert got["error"] is None and got["failed_at"] is None and ref.failed_at is None
    assert got["frames"] == ref.num_frames == FRAMES
    assert got["keyframes"] == len(ref.keyframe_ids) and got["lost"] == len(ref.lost_ids)
    assert got["b1"] == got["b2"] == 0  # the plain versions ran, not the kernels
    err_j = np.linalg.norm(ref.poses[:, :3, 3] - poses[:, :3, 3], axis=1)
    err_t = np.linalg.norm(got["poses"][:, :3, 3] - poses[:, :3, 3], axis=1)
    # The two packages' drive_trajectory differ by ~1e-5 m (float32 rounding).
    assert got["mte"] == pytest.approx(float(err_t.mean()), abs=1e-5)
    if cfg.tracker.interp == "bilinear":
        # accurate_config: tests/test_torch_pipeline.py:87's 1e-3.
        np.testing.assert_allclose(got["poses"][:, :3, 3], ref.poses[:, :3, 3], rtol=0, atol=1e-3)
        np.testing.assert_allclose(got["poses"][:, :3, :3], ref.poses[:, :3, :3], rtol=0,
                                   atol=1e-3)
    else:
        # fast_config's "mm" sampler: tests/test_torch_pipeline.py:94-96.
        assert abs(err_t.mean() - err_j.mean()) < 0.01
        np.testing.assert_allclose(got["poses"][:, :3, 3], ref.poses[:, :3, 3], rtol=0, atol=0.05)


@pytest.mark.slow
@pytest.mark.parametrize("preset", list(acc.CONFIGS))
def test_plane_seed_4_misses_the_gate_in_both_packages(preset):
    """ROADMAP C12: the sweep's plane seed 4 at 376x1241 misses bench.py's gate
    on the card (fast 0.391, accurate 0.814). On the same frames (the
    reference's, float32, on the CPU) the reference misses it too, and the
    two trajectories agree until the frames where both lose the plane."""
    cfg_j = getattr(jc, f"{preset}_config")()
    c = cfg_j.camera
    cam = JPinhole.create(c.fx, c.fy, c.cx, c.cy)
    scene = js.make_scene(4, depth=14.0)
    render = jax.jit(lambda T: js.render_stereo(scene, cam, c.baseline, T, c.height, c.width))
    poses = js.drive_trajectory(acc.NUM_FRAMES, step=0.25, seed=4)
    frames = [tuple(np.asarray(a) for a in render(jnp.asarray(T))[:2]) for T in poses]
    ref = j_run_sequence(frames, cfg_j)
    got = acc.run_one(acc.CONFIGS[preset](), poses, frames, "cpu")
    err = lambda p: float(np.linalg.norm(p[:, :3, 3] - poses[:, :3, 3], axis=1).mean())
    assert ref.failed_at is None and got["failed_at"] is None
    assert err(ref.poses) > acc.GATE and got["mte"] > acc.GATE
    gap = np.abs(got["poses"][:, :3, 3] - ref.poses[:, :3, 3]).max(axis=1)
    assert gap[:22].max() < 1e-2  # they part at frame 22 (accurate) or 29 (fast)
