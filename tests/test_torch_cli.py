"""The port's command line (odometry_torch/cli.py) on directories written
here: each subcommand runs with ``--device cpu`` and prints the reference's
fields; run-kitti's export equals a direct ``run_sequence`` of the same
frames bit for bit, and so does a checkpointed and resumed run; without
``--device`` and without a card every subcommand raises."""

import contextlib
import dataclasses
import io
import json
import os

import numpy as np
import pytest
import torch

from odometry_torch import cli
from odometry_torch.camera.pinhole import Pinhole
from odometry_torch.config import adapt_to_camera, fast_config
from odometry_torch.data import kitti, png
from odometry_torch.data.synthetic import (drive_trajectory, make_driving_scene, render_stereo,
                                           stereo_sequence)
from odometry_torch.eval.export import load_kitti_poses, save_kitti_poses
from odometry_torch.pipeline.runner import run_sequence

H, W = 96, 160
FX = 240.0
BASELINE = 386.1448 / 718.856
NUM_FRAMES = 12
KF_THRESHOLD = "0.2"
SEQ = "00"
# The reference's pipeline tolerance for a run carried on in another package (C1).
POSE_TOL = 5e-4


def _quantizer(frames):
    """One global 2-98 percentile stretch for the sequence
    (tests/test_kitti_e2e.py:47-62)."""
    allv = np.concatenate([np.asarray(im).ravel() for f in frames for im in f])
    lo, hi = float(np.percentile(allv, 2.0)), float(np.percentile(allv, 98.0))
    return lambda im: np.clip(np.round((np.asarray(im) - lo) * (255.0 / max(hi - lo, 1e-6))),
                              0, 255).astype(np.uint8)


def write_kitti_dir(root, frames, poses, fx, h, w):
    base = root / "dataset" / "sequences" / SEQ
    (base / "image_0").mkdir(parents=True)
    (base / "image_1").mkdir(parents=True)
    (root / "poses").mkdir()
    q = _quantizer(frames)
    for i, (l, r) in enumerate(frames):
        png.write_png(str(base / "image_0" / f"{i:06d}.png"), q(l))
        png.write_png(str(base / "image_1" / f"{i:06d}.png"), q(r))
    P0 = np.array([[fx, 0, w / 2.0, 0], [0, fx, h / 2.0, 0], [0, 0, 1, 0]])
    P1 = P0.copy()
    P1[0, 3] = -fx * BASELINE
    with open(base / "calib.txt", "w") as f:
        for name, P in (("P0", P0), ("P1", P1)):
            f.write(name + ": " + " ".join(f"{v:.12e}" for v in P.reshape(-1)) + "\n")
    save_kitti_poses(str(root / "poses" / f"{SEQ}.txt"), poses)
    return str(root)


def _render(num, h, w, fx, step=0.2):
    """The street scene rendered by the port's renderer on the CPU (the
    files are what both packages read)."""
    cam = Pinhole.create(fx, fx, w / 2.0, h / 2.0)
    poses = drive_trajectory(num, step=step, seed=3)
    return poses, list(stereo_sequence(make_driving_scene(3, device="cpu"), cam, BASELINE,
                                       poses, h, w))


@pytest.fixture(scope="module")
def kitti_dir(tmp_path_factory):
    poses, frames = _render(NUM_FRAMES, H, W, FX)
    return write_kitti_dir(tmp_path_factory.mktemp("kitti"), frames, poses, FX, H, W)


def _run(capsys, *argv):
    rc = cli.main([*argv, "--device", "cpu"])
    assert rc == 0
    out = capsys.readouterr().out.strip()
    return out


def _kitti_args(data, out, frames=NUM_FRAMES, *extra):
    # fast_config with lazy depth keeps the CPU's depth runs few; the slow
    # test below runs accurate_config in both packages.
    return ("run-kitti", "--data", data, "--seq", SEQ, "--frames", str(frames),
            "--config", "fast", "--lazy-depth", "--kf-threshold", KF_THRESHOLD, "--out", out,
            *extra)


@pytest.fixture(scope="module")
def kitti_run(kitti_dir, tmp_path_factory):
    """(report, out directory) of one uninterrupted run-kitti with --dump-vis."""
    out = str(tmp_path_factory.mktemp("out"))
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        rc = cli.main([*_kitti_args(kitti_dir, out, NUM_FRAMES, "--dump-vis"), "--device", "cpu"])
    assert rc == 0
    return json.loads(printed.getvalue().strip().splitlines()[-1]), out


def test_run_kitti_fields_export_and_vis(kitti_dir, kitti_run, tmp_path):
    report, out = kitti_run
    assert set(report) == {"num_frames", "fps", "keyframes", "failed_at", "lost_frames",
                           "stages", "mean_translation_error_m", "ate_rmse_m", "rpe_trans_m",
                           "rpe_rot_rad"}
    assert report["num_frames"] == NUM_FRAMES and report["failed_at"] is None
    assert {"init", "step", "sync", "io"} <= set(report["stages"])
    # The export equals a direct run_sequence of the same frames, bit for bit.
    cfg = dataclasses.replace(fast_config(), camera=kitti.load_calib(kitti_dir, SEQ),
                              depth_every_frame=False)
    cfg = adapt_to_camera(dataclasses.replace(
        cfg, keyframe=dataclasses.replace(cfg.keyframe, motion_threshold=float(KF_THRESHOLD))))
    gt = kitti.load_poses(kitti_dir, SEQ)
    pose0 = np.eye(4, dtype=np.float32)
    pose0[:3] = gt[0]
    direct = run_sequence(kitti.stereo_frames(kitti_dir, SEQ), cfg, init_pose=pose0,
                          device="cpu")
    save_kitti_poses(str(tmp_path / "direct.txt"), direct.poses)
    assert open(os.path.join(out, f"{SEQ}.txt"), "rb").read() == \
        open(tmp_path / "direct.txt", "rb").read()
    assert report["keyframes"] == len(direct.keyframe_ids) >= 2
    np.testing.assert_allclose(load_kitti_poses(os.path.join(out, f"{SEQ}.txt"))[0], gt[0],
                               atol=1e-5)
    for sub in ("gray_img_left", "disparity_left", "mask_left"):
        files = sorted(os.listdir(os.path.join(out, "vis", sub)))
        assert len(files) == report["keyframes"], sub
        assert png.read_png(os.path.join(out, "vis", sub, files[0])).shape == (H, W)


def test_run_kitti_checkpoint_resume_gives_the_uninterrupted_export(
        kitti_dir, kitti_run, tmp_path, capsys):
    out = str(tmp_path / "o")
    first = json.loads(_run(capsys, *_kitti_args(kitti_dir, out, 7, "--checkpoint-every", "3"))
                       .splitlines()[-1])
    assert first["num_frames"] == 7 and "checkpoint" in first["stages"]
    assert os.path.exists(os.path.join(out, f"{SEQ}_checkpoint.npz"))
    second = json.loads(_run(capsys, *_kitti_args(kitti_dir, out, NUM_FRAMES,
                                                  "--checkpoint-every", "3", "--resume"))
                        .splitlines()[-1])
    assert second["num_frames"] == NUM_FRAMES and "resume" in second["stages"]
    assert open(os.path.join(out, f"{SEQ}.txt"), "rb").read() == \
        open(os.path.join(kitti_run[1], f"{SEQ}.txt"), "rb").read()


def test_run_synthetic_fields(capsys):
    report = json.loads(_run(capsys, "run-synthetic", "--frames", "3", "--height", "64",
                             "--width", "128", "--config", "fast"))
    assert set(report) == {"num_frames", "fps", "keyframes", "lost_frames",
                           "mean_translation_error_m", "ate_rmse_m", "stages"}
    assert report["num_frames"] == 3


def test_eval_disparity_fields(tmp_path, capsys):
    cam = Pinhole.create(FX, FX, W / 2.0, H / 2.0)
    left, right, z = (a.numpy() for a in render_stereo(make_driving_scene(4, device="cpu"), cam,
                                                       BASELINE, np.eye(4), H, W))
    q = _quantizer([(left, right)])
    png.write_png(str(tmp_path / "view1.png"), q(left))
    png.write_png(str(tmp_path / "view5.png"), q(right))
    disp = np.where(z > 0, np.round(FX * BASELINE / z), 0).clip(0, 255).astype(np.uint8)
    png.write_png(str(tmp_path / "disp1.png"), disp)
    report = json.loads(_run(capsys, "eval-disparity", "--data", str(tmp_path), "--fx", str(FX),
                             "--baseline", str(BASELINE)))
    assert set(report) == {"num_valid", "disparity_mae_px", "depth_mae_m",
                           "disparity_cumulative", "depth_cumulative", "frame_ok"}
    assert report["num_valid"] > 0


def test_run_tum_fields(tmp_path, capsys):
    from odometry_torch.config import tum_rgbd_config

    c = tum_rgbd_config().camera
    h, w = 96, 128
    cam = Pinhole.create(c.fx / 5, c.fy / 5, w / 2.0, h / 2.0)
    poses = drive_trajectory(4, step=0.05, seed=1)
    scene = make_driving_scene(2, device="cpu")
    (tmp_path / "rgb").mkdir()
    (tmp_path / "depth").mkdir()
    lines = []
    for i, T in enumerate(poses):
        left, _, z = (a.numpy() for a in render_stereo(scene, cam, 0.1, T, h, w))
        png.write_png(str(tmp_path / "rgb" / f"{i}.png"), np.clip(left, 0, 255).astype(np.uint8))
        png.write_png(str(tmp_path / "depth" / f"{i}.png"),
                      np.clip(z * 5000, 0, 65535).astype(np.uint16))
        qx, qy, qz, qw = 0.0, 0.0, 0.0, 1.0
        tx, ty, tz = T[:3, 3]
        lines.append(f"{i}.0 {tx} {ty} {tz} {qx} {qy} {qz} {qw} {i}.0 rgb/{i}.png "
                     f"{i}.0 depth/{i}.png")
    (tmp_path / "associated.txt").write_text("\n".join(lines))
    report = json.loads(_run(capsys, "run-tum", "--data", str(tmp_path), "--frames", "4"))
    assert set(report) == {"num_frames", "fps", "num_gt_matched", "avg_translation_error_m",
                           "ate_rmse_m"}
    assert report["num_frames"] == 4 and report["num_gt_matched"] == 4


def test_run_live_fields(kitti_dir, tmp_path, capsys):
    watch = tmp_path / "watch"
    watch.mkdir()
    for i in range(3):
        l, r = kitti.frame_paths(kitti_dir, SEQ, i)
        os.link(l, watch / f"{i:03d}_left.png")
        os.link(r, watch / f"{i:03d}_right.png")
    lines = [json.loads(s) for s in
             _run(capsys, "run-live", "--watch", str(watch), "--timeout", "0.1").splitlines()]
    assert len(lines) == 3
    assert lines[0] == {"frame": "000", "init": True}
    assert set(lines[1]) == {"frame", "t", "keyframe", "depth_ok"}


@pytest.mark.parametrize("argv", [
    ["run-kitti", "--data", "nowhere"],
    ["run-tum", "--data", "nowhere"],
    ["run-synthetic"],
    ["eval-disparity", "--data", "nowhere"],
    ["run-live", "--watch", "nowhere"],
])
def test_without_device_needs_the_card(argv, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(argv)


@pytest.mark.slow
def test_run_kitti_against_the_reference(tmp_path, capsys):
    """Both packages' run-kitti on one directory at 144x320: the same
    keyframes, poses within C1's 5e-4."""
    from odometry_tpu import cli as jcli

    h, w, fx = 144, 320, 400.0
    poses, frames = _render(NUM_FRAMES, h, w, fx, step=0.12)
    data = write_kitti_dir(tmp_path / "k", frames, poses, fx, h, w)
    args = ["run-kitti", "--data", data, "--seq", SEQ, "--frames", str(NUM_FRAMES),
            "--config", "accurate", "--kf-threshold", "0.3"]
    assert jcli.main([*args, "--out", str(tmp_path / "j")]) == 0
    rj = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    rt = json.loads(_run(capsys, *args, "--out", str(tmp_path / "t")).splitlines()[-1])
    assert rt["keyframes"] == rj["keyframes"] and rt["failed_at"] == rj["failed_at"]
    np.testing.assert_allclose(load_kitti_poses(str(tmp_path / "t" / f"{SEQ}.txt")),
                               load_kitti_poses(str(tmp_path / "j" / f"{SEQ}.txt")),
                               atol=POSE_TOL, rtol=0)
