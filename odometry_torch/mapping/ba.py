"""Windowed photometric bundle adjustment with Schur-complement reduction
(port of ``mapping/ba.py``).

Jointly refines the last K keyframe poses and their points' inverse depths by
minimizing cross-keyframe photometric error. Each point p of keyframe i with
inverse depth d_p gives a residual in every other window keyframe j where its
reprojection lands,

    r_ijp = I_j(project(T_j^-1 T_i backproject(u_p, d_p))) - I_i(u_p).

The depth block of the Hessian is diagonal, so the pose system is reduced by
the Schur complement, (Hpp - Hpd Hdd^-1 Hpd') dxi = bp - Hpd Hdd^-1 bd, a
dense (6K x 6K) solve, and depths back-substitute as dd = (bd - Hpd' dxi) /
Hdd. Everything is batched over (observer j, owner i, point lane p); the
point-lane axis is what ``distributed/ba_dist.py`` splits over ranks. The
oldest window keyframe (block 0) is pinned by a large diagonal prior.

The contractions are ``torch.einsum`` in float32; the package switches TF32
off for matmuls (``odometry_torch/__init__.py``), the reference's
``Precision.HIGHEST``. ``jnp.linalg.solve`` becomes ``torch.linalg.solve_ex``
(no raise on a singular system; the non-finite guard zeroes the step).
Nothing here reads the device from the host.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from odometry_torch.camera.pinhole import Pinhole
from odometry_torch.geometry import se3_exp, se3_inverse


class BAConfig(NamedTuple):
    window: int = 7
    iters: int = 4
    huber_delta: float = 28.0
    damping: float = 1e-3
    gauge_prior: float = 1e8
    min_inv_depth: float = 1e-3
    # Refined depths outside this band keep their previous value.
    min_depth: float = 0.1
    max_depth: float = 1000.0
    # Motion-only mode: inverse depths fixed (no Schur term).
    fix_depths: bool = False


class BAProblem(NamedTuple):
    """A BA window: K keyframes with P point lanes each (struct-of-arrays)."""

    images: torch.Tensor  # (K, H, W) level-0 keyframe images
    xs: torch.Tensor  # (K, P) point pixel x in the owner frame
    ys: torch.Tensor  # (K, P)
    inv_depth: torch.Tensor  # (K, P)
    intensity: torch.Tensor  # (K, P) owner-frame intensity at the point
    point_valid: torch.Tensor  # (K, P) bool
    pose: torch.Tensor  # (K, 4, 4) cam-to-world
    kf_valid: torch.Tensor  # (K,) bool


class BAResult(NamedTuple):
    pose: torch.Tensor  # (K, 4, 4) refined poses
    inv_depth: torch.Tensor  # (K, P) refined inverse depths
    cost_initial: torch.Tensor
    cost_final: torch.Tensor
    num_residuals: torch.Tensor


def _sample_bilinear_batch(images, j_idx, u, v):
    """Bilinear sample of images[j_idx] at (u, v), clamped to the image;
    `j_idx`, `u`, `v` share one shape."""
    K, H, W = images.shape
    u = torch.clamp(u, 0.0, W - 1.0)
    v = torch.clamp(v, 0.0, H - 1.0)
    x0 = torch.floor(u)
    y0 = torch.floor(v)
    fx = u - x0
    fy = v - y0
    # float -> int of NaN is undefined in torch (XLA gives 0); the sample of
    # a NaN coordinate stays NaN through fx, fy either way.
    x0i = torch.nan_to_num(x0).long()
    y0i = torch.nan_to_num(y0).long()
    x1i = torch.clamp(x0i + 1, max=W - 1)
    y1i = torch.clamp(y0i + 1, max=H - 1)
    flat = images.reshape(-1)
    base = j_idx.long() * (H * W)

    def g(yi, xi):
        return flat[base + yi * W + xi]

    top = g(y0i, x0i) * (1.0 - fx) + g(y0i, x1i) * fx
    bot = g(y1i, x0i) * (1.0 - fx) + g(y1i, x1i) * fx
    return top * (1.0 - fy) + bot * fy


def _huber_weights(r, valid, cfg: BAConfig):
    absr = torch.abs(r)
    w = torch.where(absr <= cfg.huber_delta, torch.ones_like(r),
                    cfg.huber_delta / torch.clamp(absr, min=1e-12))
    return w * valid.to(r.dtype)


def _linearize(problem: BAProblem, cam: Pinhole, cfg: BAConfig, jac: bool = True):
    """Residuals and Jacobian blocks for every (observer j, owner i, point p).

    Returns (r, w, J_i, J_j, J_d, valid): r, w, J_d, valid (K, K, P); J_i,
    J_j (K, K, P, 6). With ``jac=False`` (the step-acceptance cost) the
    Jacobians are skipped and returned as None.
    """
    K, P = problem.xs.shape
    H, W = problem.images.shape[1:]
    dev = problem.xs.device

    d = problem.inv_depth  # (K, P)
    safe_d = torch.where(torch.abs(d) < cfg.min_inv_depth, torch.ones_like(d), d)
    Z0 = 1.0 / safe_d
    X0 = Z0 * (problem.xs - cam.cx) / cam.fx
    Y0 = Z0 * (problem.ys - cam.cy) / cam.fy
    P_i = torch.stack([X0, Y0, Z0], dim=-1)  # (K, P, 3)

    # T_ji = T_j^-1 T_i for every pair: (j, i, 4, 4).
    inv_pose = se3_inverse(problem.pose)
    T_rel = torch.einsum("jab,ibc->jiac", inv_pose, problem.pose)
    R = T_rel[..., :3, :3]
    t = T_rel[..., :3, 3]
    P_j = torch.einsum("jiab,ipb->jipa", R, P_i) + t[:, :, None, :]  # (j, i, P, 3)
    Xj, Yj, Zj = P_j[..., 0], P_j[..., 1], P_j[..., 2]
    safe_Zj = torch.where(Zj == 0, torch.ones_like(Zj), Zj)
    u = cam.fx * Xj / safe_Zj + cam.cx
    v = cam.fy * Yj / safe_Zj + cam.cy

    ar = torch.arange(K, device=dev)
    j_idx = ar[:, None, None].expand(K, K, P)
    i_idx = ar[None, :, None].expand(K, K, P)
    margin = 2.0
    valid = (
        problem.point_valid[None, :, :]
        & (torch.abs(d[None, :, :]) >= cfg.min_inv_depth)
        & problem.kf_valid[None, :, None]
        & problem.kf_valid[:, None, None]
        & (j_idx != i_idx)
        & (Zj > 0.05)
        & (u >= margin)
        & (u <= W - 1 - margin)
        & (v >= margin)
        & (v <= H - 1 - margin)
    )

    I_obs = _sample_bilinear_batch(problem.images, j_idx, u, v)
    r = I_obs - problem.intensity[None, :, :]  # (j, i, P)
    w = _huber_weights(r, valid, cfg)
    if not jac:
        return r, w, None, None, None, valid

    sample = lambda du, dv: _sample_bilinear_batch(problem.images, j_idx, u + du, v + dv)
    gx = 0.5 * (sample(1.0, 0.0) - sample(-1.0, 0.0))
    gy = 0.5 * (sample(0.0, 1.0) - sample(0.0, -1.0))

    # Image-projection chain: row vector dr/dX_j (j, i, P, 3).
    inv_Zj = 1.0 / safe_Zj
    gfxz = gx * cam.fx * inv_Zj
    gfyz = gy * cam.fy * inv_Zj
    dr_dPj = torch.stack([gfxz, gfyz, -(gfxz * Xj + gfyz * Yj) * inv_Zj], dim=-1)

    # J_i = dr_dPj R_ji [I | -hat(P_i)]; a' (-hat(P)) = -(a x P)'.
    a_i = torch.einsum("jipa,jiab->jipb", dr_dPj, R)
    Jrot_i = -torch.linalg.cross(a_i, P_i[None].expand_as(a_i), dim=-1)
    J_i = torch.cat([a_i, Jrot_i], dim=-1)
    # J_j = [-dr_dPj | dr_dPj x P_j].
    J_j = torch.cat([-dr_dPj, torch.linalg.cross(dr_dPj, P_j, dim=-1)], dim=-1)
    # d X_j / d d_p = -(X_j - t) / d.
    dPj_dd = -(P_j - t[:, :, None, :]) / safe_d[None, :, :, None]
    J_d = torch.sum(dr_dPj * dPj_dd, dim=-1)
    return r, w, J_i, J_j, J_d, valid


def _assemble_and_reduce(r, w, J_i, J_j, J_d, K: int, cfg: BAConfig):
    """Block Hessian, Schur complement over the depths; returns (Hred (6K,
    6K), bred (6K,), Hdd, bd, B, inv_Hdd)."""
    ein = torch.einsum
    # Element (j, i, p) adds to pose blocks i and j.
    H_ii = ein("jipa,jip,jipb->iab", J_i, w, J_i)
    H_jj = ein("jipa,jip,jipb->jab", J_j, w, J_j)
    H_ij = ein("jipa,jip,jipb->ijab", J_i, w, J_j)
    b_i = -ein("jipa,jip,jip->ia", J_i, w, r)
    b_j = -ein("jipa,jip,jip->ja", J_j, w, r)

    ar = torch.arange(K, device=r.device)
    Hpp = torch.zeros((K, K, 6, 6), dtype=torch.float32, device=r.device)
    Hpp[ar, ar] += H_ii + H_jj
    off_mask = 1.0 - torch.eye(K, dtype=torch.float32, device=r.device)
    H_ij = H_ij * off_mask[:, :, None, None]
    Hpp = Hpp + H_ij + H_ij.permute(1, 0, 3, 2)
    bp = b_i + b_j  # (K, 6)

    # Depth diagonal and the coupling of point (i, p) to its own block i
    # (through J_i) and to each observer block j (through J_j).
    Hdd = ein("jip,jip,jip->ip", J_d, w, J_d)
    bd = -ein("jip,jip,jip->ip", J_d, w, r)
    C_own = ein("jipa,jip,jip->ipa", J_i, w, J_d)
    C_obs = ein("jipa,jip,jip->jipa", J_j, w, J_d)
    B = C_obs.permute(1, 2, 0, 3).clone()  # (i, P, j, 6)
    # Advanced indices on axes 0 and 2 go first, as in numpy and JAX: (K, P, 6).
    B[ar, :, ar, :] += C_own

    safe_Hdd = torch.where(Hdd > 1e-12, Hdd, torch.ones_like(Hdd))
    inv_Hdd = torch.where(Hdd > 1e-12, 1.0 / safe_Hdd, torch.zeros_like(Hdd))
    if cfg.fix_depths:
        inv_Hdd = torch.zeros_like(inv_Hdd)
    Hred_corr = ein("ipka,ip,iplb->kalb", B, inv_Hdd, B)
    bred_corr = ein("ipka,ip,ip->ka", B, inv_Hdd, bd)

    Hpp_full = Hpp.permute(0, 2, 1, 3).reshape(6 * K, 6 * K)
    Hred = Hpp_full - Hred_corr.reshape(6 * K, 6 * K)
    bred = (bp - bred_corr).reshape(6 * K)
    return Hred, bred, Hdd, bd, B, inv_Hdd


def _cost(r, w):
    nres = torch.sum(w > 0)
    n = torch.clamp(nres, min=1)
    return torch.sum(w * r * r) / n.to(r.dtype), nres


def _pose_step(Hred, bred, K: int, cfg: BAConfig):
    """Gauge prior on block 0, Levenberg damping, the solve, and the guard
    that zeroes a non-finite step: dxi (K, 6)."""
    dev = Hred.device
    gauge = torch.zeros(6 * K, dtype=torch.float32, device=dev)
    gauge[:6] = cfg.gauge_prior
    Hred = Hred + torch.diag(gauge)
    Hred = (Hred + cfg.damping * torch.diag(torch.diagonal(Hred))
            + 1e-6 * torch.eye(6 * K, dtype=torch.float32, device=dev))
    dxi, info = torch.linalg.solve_ex(Hred, bred)
    ok = torch.isfinite(dxi).all() & (info == 0)
    return torch.where(ok, dxi, torch.zeros_like(dxi)).reshape(K, 6)


def _apply_step(pose, inv_depth, dxi_k, bd, B, inv_Hdd, cfg: BAConfig):
    """Candidate poses and inverse depths after a step; refined depths that
    leave [min_depth, max_depth] keep their value."""
    dd = (bd - torch.einsum("ipka,ka->ip", B, dxi_k)) * inv_Hdd
    new_pose = torch.einsum("kab,kbc->kac", pose, se3_exp(dxi_k))
    new_inv = inv_depth + dd
    depth_ok = (new_inv > 1.0 / cfg.max_depth) & (new_inv < 1.0 / cfg.min_depth)
    return new_pose, torch.where(depth_ok, new_inv, inv_depth)


def ba_solve(problem: BAProblem, cam: Pinhole, cfg: BAConfig = BAConfig()) -> BAResult:
    """Damped Gauss-Newton on the reduced pose system + depth
    back-substitution, `cfg.iters` iterations. Each candidate is scored after
    it is applied (a residual-only pass) and rolled back if the cost rose."""
    if cfg.iters < 1:
        raise ValueError(f"ba_solve: iters={cfg.iters}, needs at least one")
    K, _ = problem.xs.shape
    pose, inv_depth = problem.pose, problem.inv_depth
    cost0 = None
    for _ in range(cfg.iters):
        prob = problem._replace(pose=pose, inv_depth=inv_depth)
        r, w, J_i, J_j, J_d, _ = _linearize(prob, cam, cfg)
        cost, nres = _cost(r, w)
        Hred, bred, _, bd, B, inv_Hdd = _assemble_and_reduce(r, w, J_i, J_j, J_d, K, cfg)
        dxi_k = _pose_step(Hred, bred, K, cfg)
        new_pose, new_inv = _apply_step(pose, inv_depth, dxi_k, bd, B, inv_Hdd, cfg)
        r2, w2, *_ = _linearize(problem._replace(pose=new_pose, inv_depth=new_inv), cam, cfg,
                                jac=False)
        cand_cost, _ = _cost(r2, w2)
        accept = cand_cost <= cost
        pose = torch.where(accept, new_pose, pose)
        inv_depth = torch.where(accept, new_inv, inv_depth)
        out_cost = torch.where(accept, cand_cost, cost)
        if cost0 is None:
            cost0 = cost
    return BAResult(pose=pose, inv_depth=inv_depth, cost_initial=cost0, cost_final=out_cost,
                    num_residuals=nres)
