"""Robust weights and the unrolled 6x6 solve: port vs reference."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from odometry_tpu.solvers import linear6 as jl, robust as jr
from odometry_torch.solvers import linear6 as tl, robust as tr


@pytest.mark.parametrize("kind", ["none", "huber", "tdist"])
def test_robust_weights(kind):
    rng = np.random.default_rng(0)
    r = (rng.standard_t(3, 512) * 20).astype(np.float32)
    valid = rng.uniform(size=512) > 0.2
    wj = jr.robust_weights(kind, jnp.asarray(r), jnp.asarray(valid), tdist_dof=5.0)
    wt = tr.robust_weights(kind, torch.from_numpy(r), torch.from_numpy(valid), tdist_dof=5.0)
    # Huber/none are elementwise and exact; the t-distribution's scale is a
    # float32 sum whose order differs, iterated to tol 1e-3.
    np.testing.assert_allclose(np.asarray(wj), wt.numpy(), rtol=1e-5, atol=1e-6)


def test_solve_spd6():
    rng = np.random.default_rng(1)
    for _ in range(4):
        M = rng.normal(size=(6, 6)).astype(np.float32)
        A = (M @ M.T + 0.1 * np.eye(6)).astype(np.float32)
        b = rng.normal(size=6).astype(np.float32)
        xj = np.asarray(jl.solve_spd6(jnp.asarray(A), jnp.asarray(b)))
        xt = tl.solve_spd6(torch.from_numpy(A), torch.from_numpy(b)).numpy()
        # Same straight-line operation order; only libm-free float32 ops.
        np.testing.assert_allclose(xj, xt, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(A.astype(np.float64) @ xt, b, rtol=0, atol=1e-2)
