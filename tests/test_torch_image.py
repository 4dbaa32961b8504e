"""Blur, pyramids, gradients and samplers: port vs reference on 48x96 images."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from odometry_tpu.image import pyramid as jpyr, sampling as jsamp
from odometry_torch.image import pyramid as tpyr, sampling as tsamp

H, W = 48, 96
# Separable sums of a few float32 taps over 0-255 images: the two packages
# may round the same sums in another order (a few ulps of 255).
ATOL = 1e-4


def _img(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, 255, (H, W))).astype(np.float32)


def _close(a_jax, b_torch, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a_jax), b_torch.numpy(), atol=atol, rtol=0)


def test_blur_pyr_down_gradients():
    img = _img()
    _close(jpyr.gaussian_blur3(jnp.asarray(img)), tpyr.gaussian_blur3(torch.from_numpy(img)))
    _close(jpyr.pyr_down(jnp.asarray(img)), tpyr.pyr_down(torch.from_numpy(img)))
    for a, b in zip(jpyr.central_gradients(jnp.asarray(img)),
                    tpyr.central_gradients(torch.from_numpy(img))):
        _close(a, b)


@pytest.mark.parametrize("smooth", [True, False])
def test_image_pyramid(smooth):
    img = _img(1)
    pj = jpyr.gaussian_image_pyramid(jnp.asarray(img), 3, smooth=smooth)
    pt = tpyr.gaussian_image_pyramid(torch.from_numpy(img), 3, smooth=smooth)
    assert [tuple(a.shape) for a in pj] == [tuple(b.shape) for b in pt]
    for a, b in zip(pj, pt):
        _close(a, b)


@pytest.mark.parametrize("indexing", ["odd", "even"])
def test_depth_pyramid(indexing):
    dep = _img(2) / 255.0
    pj = jpyr.depth_pyramid(jnp.asarray(dep), 4, smooth=False, indexing=indexing)
    pt = tpyr.depth_pyramid(torch.from_numpy(dep), 4, indexing=indexing)
    for a, b in zip(pj, pt):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())  # pure decimation


def _coords(n=2000, seed=3):
    rng = np.random.default_rng(seed)
    # Includes coordinates outside the image (clamped) and exact edges.
    u = rng.uniform(-3, W + 3, n).astype(np.float32)
    v = rng.uniform(-3, H + 3, n).astype(np.float32)
    u[:4] = [0.0, W - 1.0, W - 1.5, 0.5]
    v[:4] = [0.0, H - 1.0, 0.25, H - 1.0]
    return u, v


def test_sample_bilinear_and_gathers():
    img = _img(4)
    u, v = _coords()
    _close(jsamp.sample_bilinear(jnp.asarray(img), jnp.asarray(u), jnp.asarray(v)),
           tsamp.sample_bilinear(torch.from_numpy(img), torch.from_numpy(u), torch.from_numpy(v)))
    yi, xi = np.floor(v).astype(np.int32), np.floor(u).astype(np.int32)
    np.testing.assert_array_equal(
        np.asarray(jsamp.clip_gather_2d(jnp.asarray(img), jnp.asarray(yi), jnp.asarray(xi))),
        tsamp.clip_gather_2d(torch.from_numpy(img), torch.from_numpy(yi),
                             torch.from_numpy(xi)).numpy())


def test_sample_channels_mm_semantics():
    """The "mm" sampler rounds channel values and x-weights to bf16 and
    computes 1 - fx in bf16 (reference sampling.py:100-130). With those
    roundings reproduced, both sides form the same exact bf16 x bf16
    products, so they differ only in float32 summation order: a few ulps of
    the 0-255 range. A plain float32 bilinear sample differs by up to about
    one grey level, which the second assertion shows the test would catch."""
    imgs = np.stack([_img(5), _img(6) - 128.0, _img(7) * 0.1])
    u, v = _coords(seed=8)
    sj = np.asarray(jsamp.sample_channels_mm(jnp.asarray(imgs), jnp.asarray(u), jnp.asarray(v)))
    st = tsamp.sample_channels_mm(torch.from_numpy(imgs), torch.from_numpy(u),
                                  torch.from_numpy(v)).numpy()
    np.testing.assert_allclose(sj, st, atol=ATOL, rtol=0)
    f32 = np.stack([tsamp.sample_bilinear(torch.from_numpy(c), torch.from_numpy(u),
                                          torch.from_numpy(v)).numpy() for c in imgs])
    assert np.abs(f32 - sj).max() > 10 * ATOL


def test_median_blur3_and_smoothed_depth_pyramid():
    """A 3x3 median is a selection: equal bit for bit, borders replicated."""
    img = _img(9)
    img[5, 7] = 1e6  # an outlier the median removes
    np.testing.assert_array_equal(np.asarray(jpyr.median_blur3(jnp.asarray(img))),
                                  tpyr.median_blur3(torch.from_numpy(img)).numpy())
    rng = np.random.default_rng(10)
    dep = np.where(rng.random((H, W)) > 0.7, rng.random((H, W)), 0.0).astype(np.float32)
    for indexing in ("odd", "even"):
        pj = jpyr.depth_pyramid(jnp.asarray(dep), 4, smooth=True, indexing=indexing)
        pt = tpyr.depth_pyramid(torch.from_numpy(dep), 4, smooth=True, indexing=indexing)
        assert len(pj) == len(pt) == 4
        for a, b in zip(pj, pt):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_gradient_magnitude():
    """Clamped central differences are exact in both; the square root of
    their squared sum rounds once more: within 1e-6 relative."""
    img = _img(11)
    np.testing.assert_allclose(np.asarray(jpyr.gradient_magnitude(jnp.asarray(img))),
                               tpyr.gradient_magnitude(torch.from_numpy(img)).numpy(),
                               rtol=1e-6, atol=0)


def test_sample_floor_bilinear_mm_and_remap():
    """sample_floor is a selection (exact). sample_bilinear_mm in float32 and
    remap_bilinear blend four float32 taps, the reference's "mm" form as a
    matmul, so in another order: within 1e-6 relative (a float32 ulp near
    255 is 1.5e-5 absolute). In bf16 the "mm" rounding of
    test_sample_channels_mm_semantics holds."""
    img = _img(12)
    u, v = _coords(seed=13)
    ju, jv, tu, tv = jnp.asarray(u), jnp.asarray(v), torch.from_numpy(u), torch.from_numpy(v)
    np.testing.assert_array_equal(np.asarray(jsamp.sample_floor(jnp.asarray(img), ju, jv)),
                                  tsamp.sample_floor(torch.from_numpy(img), tu, tv).numpy())
    np.testing.assert_allclose(
        np.asarray(jsamp.sample_bilinear_mm(jnp.asarray(img), ju, jv, dtype=jnp.float32)),
        tsamp.sample_bilinear_mm(torch.from_numpy(img), tu, tv, dtype=torch.float32).numpy(),
        rtol=1e-6, atol=0)
    _close(jsamp.sample_bilinear_mm(jnp.asarray(img), ju, jv),
           tsamp.sample_bilinear_mm(torch.from_numpy(img), tu, tv))
    rng = np.random.default_rng(14)
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)
    map_u = (xs + rng.uniform(-3, 3, (H, W))).astype(np.float32)
    map_v = (ys + rng.uniform(-3, 3, (H, W))).astype(np.float32)
    np.testing.assert_allclose(
        np.asarray(jsamp.remap_bilinear(jnp.asarray(img), jnp.asarray(map_u), jnp.asarray(map_v))),
        tsamp.remap_bilinear(torch.from_numpy(img), torch.from_numpy(map_u),
                             torch.from_numpy(map_v)).numpy(),
        rtol=1e-6, atol=0)
