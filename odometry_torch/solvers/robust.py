"""Robust weighting: none / Huber / t-distribution (port of ``solvers/robust.py``).

Reproduces ``lm_optimizer.cpp:249-261`` and ``ComputeScaleNaive``
(``lm_optimizer.cpp:338-358``).
"""

from __future__ import annotations

import torch


def huber_weights(r: torch.Tensor, delta: float, valid: torch.Tensor) -> torch.Tensor:
    """w_i = 1 if |r_i| <= delta else delta/|r_i| (lm_optimizer.cpp:254)."""
    a = torch.abs(r)
    # A tensor numerator: `float / tensor` is reciprocal-then-multiply in
    # torch, one rounding more than the reference's division.
    w = torch.where(a <= delta, torch.ones_like(a), a.new_tensor(delta) / torch.clamp(a, min=1e-12))
    return w * valid.to(r.dtype)


def tdist_scale(r: torch.Tensor, valid: torch.Tensor, *, dof: float = 200.0,
                sigma_init: float = 5.0, tol: float = 1e-3,
                max_iters: int = 50) -> torch.Tensor:
    """Fixed-point scale of the t-distribution M-estimator:
    sigma^2 <- mean_i [ r_i^2 (1+nu) / (nu + r_i^2 / sigma^2) ] until
    |sigma_new - sigma_old| < tol (do-while, bounded by `max_iters`).

    The convergence test is read on the host once per iteration.
    """
    vf = valid.to(r.dtype)
    n = torch.clamp(torch.sum(vf), min=1.0)
    r2 = r * r * vf
    sigma = torch.tensor(sigma_init, dtype=r.dtype, device=r.device)
    prev = sigma + 1e9
    it = 0
    while it < max_iters and bool(torch.abs(sigma - prev) >= tol):
        s = torch.sum(r2 * (1.0 + dof) / (dof + r2 / (sigma * sigma)))
        sigma, prev = torch.sqrt(s / n), sigma
        it += 1
    return sigma


def tdist_weights(r: torch.Tensor, valid: torch.Tensor, *, dof: float = 200.0,
                  sigma_init: float = 5.0) -> torch.Tensor:
    """w_i = (nu+1) / (nu + r_i^2/sigma^2) (lm_optimizer.cpp:257-261)."""
    sigma = tdist_scale(r, valid, dof=dof, sigma_init=sigma_init)
    w = r.new_tensor(dof + 1.0) / (dof + r * r / (sigma * sigma))
    return w * valid.to(r.dtype)


def robust_weights(kind: str, r: torch.Tensor, valid: torch.Tensor, *,
                   huber_delta: float = 28.0, tdist_dof: float = 200.0,
                   tdist_sigma_init: float = 5.0) -> torch.Tensor:
    if kind == "none":
        return valid.to(r.dtype)
    if kind == "huber":
        return huber_weights(r, huber_delta, valid)
    if kind == "tdist":
        return tdist_weights(r, valid, dof=tdist_dof, sigma_init=tdist_sigma_init)
    raise ValueError(f"unknown robust estimator {kind!r}")
