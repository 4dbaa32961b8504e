"""Depth frontend: port vs reference compute_depth on the same stereo pair."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from odometry_tpu import config as jc
from odometry_tpu.camera import Pinhole as JPinhole
from odometry_tpu.data.synthetic import make_scene, render_stereo
from odometry_tpu.depth import estimator as je
from odometry_torch import config as tc
from odometry_torch.depth import estimator as te

# The 144x320 camera of tests/test_pipeline.py:288-295.
HS, WS = 144, 320
CAM = dict(fx=180.0, fy=180.0, cx=WS / 2.0, cy=HS / 2.0, baseline=0.537, height=HS, width=WS)
CAM_J, CAM_T = jc.CameraConfig(**CAM), tc.CameraConfig(**CAM)


def _cases(C):
    """The depth configurations under test, built by config module `C` (each
    package gets its own)."""
    fast = C.fast_config().depth
    return {
        # The fast_config path: banded search [3, 192] with the left-right
        # check, gradient-ranked blocked extraction, window-patch refinement.
        "fast": fast,
        # Full-image lane refinement of the same selection.
        "fast_full_refine": dataclasses.replace(fast, refine_backend="full"),
        # Full search (no band), row-order lanes, full-image bilinear
        # refinement of the matched lanes. Lanes that start unmatched from
        # inverse depth 0 (refine_unmatched, the reference default) jump tens
        # of pixels, which amplifies the reference's fused multiply-adds (see
        # test_floor_warp_matches_eager_reference) past any fixed tolerance.
        "full_search": C.DepthConfig(block_rows=8, block_cols=16, min_valid_points=30,
                                     interp="bilinear", refine_unmatched=False),
    }


CASES_J, CASES_T = _cases(jc), _cases(tc)


@pytest.fixture(scope="module")
def stereo():
    cam = JPinhole.create(180.0, 180.0, WS / 2.0, HS / 2.0)
    scene = make_scene(3, depth=14.0)
    left, right, _ = render_stereo(scene, cam, 0.537, jnp.eye(4), HS, WS)
    return np.array(left), np.array(right)


@pytest.mark.parametrize("case", sorted(CASES_T))
def test_compute_depth_matches_reference(stereo, case):
    left, right = stereo
    rj = je.compute_depth(jnp.asarray(left), jnp.asarray(right), CAM_J, CASES_J[case])
    rt = te.compute_depth(torch.from_numpy(left), torch.from_numpy(right), CAM_T, CASES_T[case])
    nj, nt = int(rj.num_valid), int(rt.num_valid)
    assert nj > 500
    # Survivor count within 1%, validity IoU >= 0.98: float32 sums in another
    # order may flip a near-tie SSD winner or a lane at a filter threshold.
    assert abs(nj - nt) <= 0.01 * nj
    vj, vt = np.asarray(rj.valid), rt.valid.numpy()
    assert (vj & vt).sum() / (vj | vt).sum() >= 0.98
    assert bool(rj.ok) == bool(rt.ok)
    both = vj & vt
    # Inverse depth on common pixels within 1e-4 (1/m): a 1/64 px disparity
    # at fx * baseline ~ 97 px*m.
    np.testing.assert_allclose(rt.inv_depth.numpy()[both], np.asarray(rj.inv_depth)[both],
                               rtol=0, atol=1e-4)
    assert np.all(rt.inv_depth.numpy()[~vt] == 0.0)
    np.testing.assert_array_equal(rt.disparity.numpy()[both], np.asarray(rj.disparity)[both])


def test_compute_depth_fails_on_textureless():
    flat = torch.full((HS, WS), 128.0)
    res = te.compute_depth(flat, flat, CAM_T, CASES_T["fast"])
    assert not bool(res.ok) and int(res.num_valid) == 0
    assert not res.valid.any()


def test_floor_warp_matches_eager_reference(stereo):
    """Pins the first divergence of the floor-warp refinement (ROADMAP C).

    From identical lanes, the port's residual system equals the reference's
    when the reference runs op by op. Under jit, XLA:CPU contracts the warp
    ``xs - tx_fx * d`` into a fused multiply-add (one rounding instead of
    two), which moves ~25 of ~7600 lanes across an integer pixel boundary of
    the floor warp; compute_depth with floor warps and unmatched lanes then
    differs by ~1% in survivors. The port keeps the two-rounding arithmetic
    of the reference's source.
    """
    left, right = stereo
    rng = np.random.default_rng(0)
    n = 2048
    ys = rng.integers(4, HS - 4, n).astype(np.int32)
    xs = rng.integers(4, WS - 4, n).astype(np.float32)
    d = (rng.uniform(0, 40, n) / (CAM["fx"] * CAM["baseline"])).astype(np.float32)
    d[::7] = 0.0
    valid = rng.uniform(size=n) > 0.1
    tx_fx = CAM["baseline"] * CAM["fx"]
    from odometry_tpu.image.pyramid import central_gradients as jgrad
    from odometry_torch.image.pyramid import central_gradients as tgrad

    left_I = left[ys, xs.astype(np.int32)]
    outs_j = je._eval_system_points(
        jnp.asarray(d), jnp.asarray(left_I), jnp.asarray(right), jnp.asarray(ys),
        jnp.asarray(xs), jnp.asarray(valid), WS, tx_fx, 28.0, "floor",
        jgrad(jnp.asarray(right))[0], None)
    t = torch.from_numpy
    r_t = torch.from_numpy(right)
    wx = torch.clamp(torch.floor(t(xs) - tx_fx * t(d)).long(), 1, WS - 2)
    warped = torch.floor(t(xs) - tx_fx * t(d)).long()
    in_b = (warped >= 2) & (warped <= WS - 2) & t(valid)
    yl = t(ys).long()
    r = t(left_I) - r_t[yl, wx]
    g = tx_fx * tgrad(r_t)[0][yl, wx]
    outs_t = te._huber_system(r, g, in_b, 28.0)
    for a, b in zip(outs_j, outs_t):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
