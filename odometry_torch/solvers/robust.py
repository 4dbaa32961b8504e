"""Robust weighting: none / Huber / t-distribution (port of ``solvers/robust.py``).

Reproduces ``lm_optimizer.cpp:249-261`` and ``ComputeScaleNaive``
(``lm_optimizer.cpp:338-358``). Residuals are one image's lanes, or a batch
with `batch_dims` leading axes: the t-distribution's scale is then one per
image.
"""

from __future__ import annotations

import torch

from odometry_torch.utils.profiling import span


def huber_weights(r: torch.Tensor, delta: float, valid: torch.Tensor) -> torch.Tensor:
    """w_i = 1 if |r_i| <= delta else delta/|r_i| (lm_optimizer.cpp:254)."""
    a = torch.abs(r)
    # A tensor numerator: `float / tensor` is reciprocal-then-multiply in
    # torch, one rounding more than the reference's division. Filled on the
    # device (no copy from the host), so that a CUDA graph can capture it.
    w = torch.where(a <= delta, torch.ones_like(a),
                    torch.full_like(a, delta) / torch.clamp(a, min=1e-12))
    return w * valid.to(r.dtype)


def tdist_scale(r: torch.Tensor, valid: torch.Tensor, *, dof: float = 200.0,
                sigma_init: float = 5.0, tol: float = 1e-3, max_iters: int = 50,
                batch_dims: int = 0) -> torch.Tensor:
    """Fixed-point scale of the t-distribution M-estimator:
    sigma^2 <- mean_i [ r_i^2 (1+nu) / (nu + r_i^2 / sigma^2) ] until
    |sigma_new - sigma_old| < tol (do-while, bounded by `max_iters`).

    The mean runs over all but the `batch_dims` leading axes, so a batch
    has one scale per image, shaped r.shape[:batch_dims]. Each image keeps
    its own loop: its scale stops where its own test stops it, and the loop
    runs while some image goes on, the test read on the host once per
    iteration for the whole batch.
    """
    dims = tuple(range(batch_dims, r.dim()))
    vf = valid.to(r.dtype)
    n = torch.clamp(torch.sum(vf, dim=dims), min=1.0)
    r2 = r * r * vf
    sigma = torch.full(n.shape, sigma_init, dtype=r.dtype, device=r.device)
    prev = sigma + 1e9
    bcast = (...,) + (None,) * len(dims)
    it = 0
    going = torch.abs(sigma - prev) >= tol
    while it < max_iters:
        with span("read.tdist_scale"):
            more = bool(going.any())
        if not more:
            break
        s = torch.sum(r2 * (1.0 + dof) / (dof + r2 / (sigma * sigma)[bcast]), dim=dims)
        sigma, prev = torch.where(going, torch.sqrt(s / n), sigma), torch.where(going, sigma, prev)
        going = going & (torch.abs(sigma - prev) >= tol)
        it += 1
    return sigma


def tdist_weights(r: torch.Tensor, valid: torch.Tensor, *, dof: float = 200.0,
                  sigma_init: float = 5.0, batch_dims: int = 0) -> torch.Tensor:
    """w_i = (nu+1) / (nu + r_i^2/sigma^2) (lm_optimizer.cpp:257-261)."""
    sigma = tdist_scale(r, valid, dof=dof, sigma_init=sigma_init, batch_dims=batch_dims)
    sigma = sigma[(...,) + (None,) * (r.dim() - batch_dims)]
    w = r.new_tensor(dof + 1.0) / (dof + r * r / (sigma * sigma))
    return w * valid.to(r.dtype)


def robust_weights(kind: str, r: torch.Tensor, valid: torch.Tensor, *,
                   huber_delta: float = 28.0, tdist_dof: float = 200.0,
                   tdist_sigma_init: float = 5.0, batch_dims: int = 0) -> torch.Tensor:
    """Weights of `r`'s lanes; `batch_dims` leading axes index images of a
    batch (only the t-distribution's scale reduces over lanes)."""
    if kind == "none":
        return valid.to(r.dtype)
    if kind == "huber":
        return huber_weights(r, huber_delta, valid)
    if kind == "tdist":
        return tdist_weights(r, valid, dof=tdist_dof, sigma_init=tdist_sigma_init,
                             batch_dims=batch_dims)
    raise ValueError(f"unknown robust estimator {kind!r}")
