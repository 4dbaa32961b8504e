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
