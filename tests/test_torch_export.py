"""Trajectory and keyframe export, and the disparity report: the port
against the reference on the same arrays."""

import os

import numpy as np
from PIL import Image

from odometry_tpu.eval import disparity_eval as jde, export as jex
from odometry_torch.data import png
from odometry_torch.eval import disparity_eval as tde, export as tex


def test_kitti_pose_files_are_byte_identical(tmp_path):
    rng = np.random.default_rng(1)
    poses = np.tile(np.eye(4, dtype=np.float32), (7, 1, 1))
    poses[:, :3, :] += rng.normal(0, 3, (7, 3, 4)).astype(np.float32)
    for shape in ((7, 4, 4), (7, 3, 4)):
        p = poses if shape[1] == 4 else poses[:, :3, :]
        a, b = str(tmp_path / "t.txt"), str(tmp_path / "j.txt")
        tex.save_kitti_poses(a, p)
        jex.save_kitti_poses(b, p)
        assert open(a, "rb").read() == open(b, "rb").read()
        np.testing.assert_array_equal(tex.load_kitti_poses(a), jex.load_kitti_poses(b))
        np.testing.assert_allclose(tex.load_kitti_poses(a), poses[:, :3, :], atol=5e-7)


def test_keyframe_dumps_decode_to_the_reference_arrays(tmp_path):
    rng = np.random.default_rng(2)
    H, W = 30, 44
    images = [rng.uniform(-20, 280, (H, W)).astype(np.float32) for _ in range(3)]
    disps = [rng.uniform(0, 0.5, (H, W)).astype(np.float32) for _ in range(3)]
    masks = [rng.random((H, W)) > 0.6 for _ in range(3)]
    kw = dict(images=images, disparities=disps, masks=masks, keyframe_ids=[0, 5, 9],
              disparity_scale=386.1448)
    tex.save_keyframe_dumps(str(tmp_path / "t"), **kw)
    jex.save_keyframe_dumps(str(tmp_path / "j"), **kw)
    for sub in ("gray_img_left", "disparity_left", "mask_left"):
        names = sorted(os.listdir(tmp_path / "t" / sub))
        assert names == sorted(os.listdir(tmp_path / "j" / sub)) == ["0.png", "1.png", "2.png"]
        for n in names:
            ours, ref = str(tmp_path / "t" / sub / n), str(tmp_path / "j" / sub / n)
            expected = np.asarray(Image.open(ref))
            for decoded in (png.read_png(ours), np.asarray(Image.open(ours))):
                assert decoded.dtype == expected.dtype, (sub, n)
                np.testing.assert_array_equal(decoded, expected, err_msg=f"{sub}/{n}")
    ids = "keyframe_ids/keyframe_id.txt"
    assert open(tmp_path / "t" / ids).read() == open(tmp_path / "j" / ids).read() == "0\n5\n9\n"


def test_disparity_histograms_equal_reference():
    rng = np.random.default_rng(3)
    gt = np.where(rng.random((40, 60)) > 0.2, rng.uniform(1, 60, (40, 60)), 0.0)
    pred = gt + rng.normal(0, 2, gt.shape)
    valid = rng.random(gt.shape) > 0.3
    kw = dict(fx=718.856, baseline=0.537)
    assert tde.disparity_histograms(pred, gt, valid, **kw) == \
        jde.disparity_histograms(pred, gt, valid, **kw)
    none = np.zeros_like(valid)
    assert tde.disparity_histograms(pred, gt, none, **kw) == {"num_valid": 0}
