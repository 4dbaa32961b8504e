"""Dataset loaders: the port's KITTI, TUM and Middlebury readers against the
reference's on the same files (the reference's own fixtures of
tests/test_data.py, run through both packages), each equal exactly."""

import dataclasses

import numpy as np
import pytest
from PIL import Image

from odometry_tpu.data import kitti as jkitti, middlebury as jmid, tum as jtum
from odometry_torch.data import kitti as tkitti, middlebury as tmid, tum as ttum
from odometry_torch.data import native_loader as tnative


def _mk_kitti(root, n=4, h=24, w=32, rgb_right=False):
    rng = np.random.default_rng(0)
    base = root / "dataset" / "sequences" / "00"
    (base / "image_0").mkdir(parents=True)
    (base / "image_1").mkdir(parents=True)
    (root / "poses").mkdir()
    for i in range(n):
        a = (rng.random((h, w)) * 255).astype(np.uint8)
        b = (rng.random((h, w, 3) if rgb_right else (h, w)) * 255).astype(np.uint8)
        Image.fromarray(a).save(base / "image_0" / f"{i:06d}.png")
        Image.fromarray(b).save(base / "image_1" / f"{i:06d}.png")
    with open(root / "poses" / "00.txt", "w") as f:
        for i in range(n):
            P = np.hstack([np.eye(3), [[i * 0.5], [0.1 * i], [-0.25 * i]]]).astype(np.float32)
            f.write(" ".join(str(v) for v in P.reshape(-1)) + "\n")
    with open(base / "calib.txt", "w") as f:
        f.write("P0: 700.0 0 16.0 0 0 700.0 12.0 0 0 0 1 0\n")
        f.write("P1: 700.0 0 16.0 -350.0 0 700.0 12.0 0 0 0 1 0\n")
    return str(root)


def _same_frames(a, b):
    a, b = list(a), list(b)
    assert len(a) == len(b) > 0
    for (l1, r1), (l2, r2) in zip(a, b):
        assert l1.dtype == l2.dtype == np.float32
        np.testing.assert_array_equal(l1, l2)
        np.testing.assert_array_equal(r1, r2)


@pytest.mark.parametrize("use_native", [False, True])
def test_kitti_loader_equals_reference(tmp_path, use_native):
    root = _mk_kitti(tmp_path)
    assert tkitti.num_frames(root, "00") == jkitti.num_frames(root, "00") == 4
    frames = tkitti.stereo_frames(root, "00", start=1, count=2, use_native=use_native)
    if use_native and frames.decoder != "native":
        pytest.skip(f"native toolchain unavailable: {frames.reason}")
    assert frames.decoder == ("native" if use_native else "png")
    assert len(frames) == 2
    _same_frames(frames, jkitti.stereo_frames(root, "00", start=1, count=2,
                                              use_native=use_native))
    np.testing.assert_array_equal(tkitti.load_poses(root, "00", 3),
                                  jkitti.load_poses(root, "00", 3))
    assert dataclasses.asdict(tkitti.load_calib(root, "00")) == \
        dataclasses.asdict(jkitti.load_calib(root, "00"))
    assert tkitti.frame_paths(root, "00", 7) == jkitti.frame_paths(root, "00", 7)
    # No calib.txt: the reference's hard-coded sequence-00 camera.
    assert dataclasses.asdict(tkitti.load_calib(str(tmp_path / "none"), "00")) == \
        dataclasses.asdict(jkitti.load_calib(str(tmp_path / "none"), "00"))


def test_kitti_colour_frames_follow_each_decoder(tmp_path):
    """A colour right image: the numpy decoder gives PIL's grey (as the
    reference's PIL path), the native decoder its own rule (as the
    reference's native path)."""
    root = _mk_kitti(tmp_path, rgb_right=True)
    _same_frames(tkitti.stereo_frames(root, use_native=False),
                 jkitti.stereo_frames(root, use_native=False))
    native = tkitti.stereo_frames(root, use_native=True)
    if native.decoder != "native":
        pytest.skip(f"native toolchain unavailable: {native.reason}")
    _same_frames(native, jkitti.stereo_frames(root, use_native=True))


def test_kitti_falls_back_and_says_why(tmp_path, monkeypatch):
    root = _mk_kitti(tmp_path)

    def no_compiler():
        raise tnative.NativeLoaderUnavailable("native build failed: g++: not found")

    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "_build", no_compiler)
    frames = tkitti.stereo_frames(root, use_native=True)
    assert frames.decoder == "png"
    assert "g++: not found" in frames.reason
    _same_frames(frames, jkitti.stereo_frames(root, use_native=False))


def _tum_images(tmp_path, rng, n, h, w, scale):
    (tmp_path / "rgb").mkdir()
    (tmp_path / "depth").mkdir()
    for i in range(n):
        g = (rng.random((h, w, 3) if i == 0 else (h, w)) * 255).astype(np.uint8)
        d = (rng.random((h, w)) * scale).astype(np.uint16)
        Image.fromarray(g).save(tmp_path / "rgb" / f"{i}.png")
        Image.fromarray(d).save(tmp_path / "depth" / f"{i}.png")


def _same_assoc(a, b):
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        assert (x.gray_ts, x.gray_path, x.depth_ts, x.depth_path) == \
            (y.gray_ts, y.gray_path, y.depth_ts, y.depth_path)
        assert (x.gt_pose is None) == (y.gt_pose is None)
        if x.gt_pose is not None:
            np.testing.assert_array_equal(x.gt_pose, y.gt_pose)


def test_tum_four_column_file_and_groundtruth(tmp_path):
    rng = np.random.default_rng(2)
    _tum_images(tmp_path, rng, 3, 20, 24, 10000)
    (tmp_path / "associated.txt").write_text(
        "\n".join(f"{i}.0 rgb/{i}.png {i}.0 depth/{i}.png" for i in range(3)))
    (tmp_path / "groundtruth.txt").write_text(
        "# header\n0.0 0 0 0 0 0 0 1\n1.0 1 0 0 0.1 0.2 0.3 0.9\n")
    d = str(tmp_path)
    _same_assoc(ttum.read_associations_full(d), jtum.read_associations_full(d))
    assert ttum.read_associations(d) == jtum.read_associations(d)
    _same_frames(ttum.rgbd_frames(d), jtum.rgbd_frames(d))  # grey incl. an RGB frame, inv depth
    for a, b in zip(ttum.load_groundtruth(d), jtum.load_groundtruth(d)):
        np.testing.assert_array_equal(a, b)
    ts, gt = ttum.load_groundtruth(d)
    for a, b in zip(ttum.associate_groundtruth(np.asarray([0.0, 0.5, 1.01]), ts, gt),
                    jtum.associate_groundtruth(np.asarray([0.0, 0.5, 1.01]), ts, gt)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(ttum._quat_to_mat(0.1, -0.2, 0.3, 0.9),
                                  jtum._quat_to_mat(0.1, -0.2, 0.3, 0.9))
    np.testing.assert_array_equal(ttum.load_depth(str(tmp_path / "depth" / "1.png")),
                                  jtum.load_depth(str(tmp_path / "depth" / "1.png")))


def test_tum_associations_built_without_file(tmp_path):
    rng = np.random.default_rng(4)
    _tum_images(tmp_path, rng, 3, 10, 12, 5000)
    rgb = ["# rgb"] + [f"{i}.000 rgb/{i}.png" for i in range(3)]
    dep = ["# depth"] + [f"{i}.008 depth/{i}.png" for i in range(3)] + ["1.500 depth/0.png"]
    (tmp_path / "rgb.txt").write_text("\n".join(rgb))
    (tmp_path / "depth.txt").write_text("\n".join(dep))
    d = str(tmp_path)
    _same_assoc(ttum.read_associations_full(d), jtum.read_associations_full(d))
    assert len(ttum.read_associations_full(d)) == 3
    ts_a = np.asarray([0.00, 1.00, 2.00, 3.00])
    ts_b = np.asarray([0.015, 0.018, 1.30, 2.005, 3.019])
    assert ttum.associate(ts_a, ts_b, 0.02) == jtum.associate(ts_a, ts_b, 0.02) == \
        [(0, 0), (2, 3), (3, 4)]


def test_tum_reference_12_column_format(tmp_path):
    rng = np.random.default_rng(5)
    _tum_images(tmp_path, rng, 2, 10, 12, 5000)
    (tmp_path / "associated.txt").write_text("\n".join(
        f"{i}.0 {i * 0.5} 0 0 0 0.{i} 0 1 {i}.001 rgb/{i}.png {i}.002 depth/{i}.png"
        for i in range(2)))
    d = str(tmp_path)
    _same_assoc(ttum.read_associations_full(d), jtum.read_associations_full(d))
    assert ttum.read_associations_full(d)[1].gt_pose is not None
    _same_frames(ttum.rgbd_frames(d, count=1), jtum.rgbd_frames(d, count=1))


@pytest.mark.parametrize("disp_kind", ["L", "RGB", "I;16"])
def test_middlebury_equals_reference(tmp_path, disp_kind):
    rng = np.random.default_rng(3)
    a = (rng.random((16, 20, 3)) * 255).astype(np.uint8)
    Image.fromarray(a).save(tmp_path / "view1.png")
    Image.fromarray(a[..., 0]).save(tmp_path / "view5.png")
    disp = {"L": a[..., 1] // 4, "RGB": a // 4,
            "I;16": a[..., 2].astype(np.uint16) * 257}[disp_kind]
    Image.fromarray(disp).save(tmp_path / "disp1.png")
    for x, y in zip(tmid.load_pair(str(tmp_path), disp_scale=2.0),
                    jmid.load_pair(str(tmp_path), disp_scale=2.0)):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)
