"""Synthetic scenes: the port's scene makers, renderer, trajectories and
nuisance model vs the reference's."""

import importlib.util
import pathlib

import numpy as np
import jax
import jax.numpy as jnp
import torch

from odometry_tpu.camera import Pinhole as JPinhole
from odometry_tpu.data import synthetic as js
from odometry_torch.camera.pinhole import Pinhole as TPinhole
from odometry_torch.data import synthetic as ts

H, W = 48, 96
FIELDS = ("normal", "offset", "freqs", "amps", "phases", "blob_centers", "blob_inv2s2",
          "blob_amps")


def test_make_scene_and_trajectory_identical():
    sj, st = js.make_scene(3, depth=14.0), ts.make_scene(3, depth=14.0, device="cpu")
    for f in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(sj, f)), getattr(st, f).numpy())
    # The same numpy draws; the twists are exponentiated in float32 by each
    # package's se3_exp (tests/test_torch_geometry.py holds those to 1e-5).
    np.testing.assert_allclose(ts.drive_trajectory(6, step=0.35, seed=4),
                               js.drive_trajectory(6, step=0.35, seed=4), rtol=0, atol=1e-5)


def test_render_stereo_matches_reference():
    sj, st = js.make_scene(3, depth=14.0), ts.make_scene(3, depth=14.0, device="cpu")
    T = js.drive_trajectory(3, step=0.35, seed=4)[2]
    cam = (0.58 * W, 0.58 * W, W / 2.0, H / 2.0)
    ref = jax.jit(lambda T_: js.render_stereo(sj, JPinhole.create(*cam), 0.537, T_, H, W))(
        jnp.asarray(T))
    port = ts.render_stereo(st, TPinhole.create(*cam), 0.537, torch.from_numpy(T), H, W)
    # Depth: one ray-plane intersection, float32 rounding only.
    np.testing.assert_allclose(port[2].numpy(), np.asarray(ref[2]), rtol=1e-5)
    # Intensity: 48 sines of phases up to a few hundred radians, whose
    # float32 rounding (~1e-5 rad) is multiplied by amplitudes of ~10 grey
    # levels: within 0.05 of the 0-255 range.
    for a, b in zip(ref[:2], port[:2]):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0, atol=0.05)


MULTI_FIELDS = ("normals", "offsets", "freqs", "amps", "phases", "blob_centers",
                "blob_inv2s2", "blob_amps")


def test_driving_and_natural_scenes_identical():
    for seed in (3, 4):
        sj = js.make_driving_scene(seed, side_x=20.0, wall_z=26.0)
        st = ts.make_driving_scene(seed, side_x=20.0, wall_z=26.0, device="cpu")
        for f in MULTI_FIELDS:
            np.testing.assert_array_equal(np.asarray(getattr(sj, f)), getattr(st, f).numpy())
        assert float(sj.ridge) == st.ridge == 0.0
        nj, nt = js.make_natural_scene(seed), ts.make_natural_scene(seed, device="cpu")
        for f in FIELDS:
            np.testing.assert_array_equal(np.asarray(getattr(nj, f)), getattr(nt, f).numpy())
        assert float(nj.ridge) == nt.ridge == 1.0


def test_render_multiplane_and_natural_match_reference():
    T = js.drive_trajectory(3, step=0.25, seed=4)[2]
    cam = (0.58 * W, 0.58 * W, W / 2.0, H / 2.0)
    for sj, st in ((js.make_driving_scene(3), ts.make_driving_scene(3, device="cpu")),
                   (js.make_natural_scene(5), ts.make_natural_scene(5, device="cpu"))):
        ref = jax.jit(lambda T_: js.render_stereo(sj, JPinhole.create(*cam), 0.537, T_, H, W))(
            jnp.asarray(T))
        port = ts.render_stereo(st, TPinhole.create(*cam), 0.537, torch.from_numpy(T), H, W)
        # Depth: one ray-plane intersection per plane, float32 rounding only.
        np.testing.assert_allclose(port[2].numpy(), np.asarray(ref[2]), rtol=1e-5)
        # Intensity within 0.05 grey level, as for the plane
        # (test_render_stereo_matches_reference).
        for a, b in zip(ref[:2], port[:2]):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0, atol=0.05)


def test_stereo_sequence_and_nuisance_match_reference():
    poses = js.drive_trajectory(2, step=0.25, seed=4)
    cam = (0.58 * W, 0.58 * W, W / 2.0, H / 2.0)
    ref = list(js.stereo_sequence(js.make_driving_scene(3), JPinhole.create(*cam), 0.537, poses,
                                  H, W))
    port = list(ts.stereo_sequence(ts.make_driving_scene(3, device="cpu"), TPinhole.create(*cam),
                                   0.537, poses, H, W))
    assert len(port) == len(ref) == 2
    for (lj, rj), (lt, rt) in zip(ref, port):
        assert isinstance(lt, np.ndarray) and lt.dtype == np.float32
        np.testing.assert_allclose(lt, lj, rtol=0, atol=0.05)
        np.testing.assert_allclose(rt, rj, rtol=0, atol=0.05)
    # The nuisance model is host-side numpy in both: the same frames give the
    # same bits.
    img = ref[1][0]
    for seed, frame, eye in ((0, 0, 0), (5, 7, 1)):
        nj, nt = js.PhotometricNuisance(seed=seed), ts.PhotometricNuisance(seed=seed)
        np.testing.assert_array_equal(ts.apply_nuisance(img, frame, nt, eye=eye),
                                      js.apply_nuisance(img, frame, nj, eye=eye))


def _chip_smoke():
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_tpu_phase_scene():
    # chip_smoke's scene rounds the texture phase operands to bf16, as the
    # TPU's default matmul precision does: another texture of the same
    # scene, and the same depth.
    st = ts.make_scene(3, depth=14.0, device="cpu")
    tpu = _chip_smoke().tpu_phase_scene(st)
    T = torch.from_numpy(js.drive_trajectory(3, step=0.35, seed=4)[2])
    cam = TPinhole.create(0.58 * W, 0.58 * W, W / 2.0, H / 2.0)
    left, z = ts.render(st, cam, T, H, W)
    left_tpu, z_tpu = ts.render(tpu, cam, T, H, W)
    assert np.abs(left_tpu.numpy() - left.numpy()).max() > 1.0
    assert torch.isfinite(left_tpu).all()
    assert torch.equal(z_tpu, z)
