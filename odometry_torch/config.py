"""Typed configuration for the whole engine (the port's own copy of
``odometry_tpu/config.py``).

The reference hard-codes every constant at the call site
(``run_odometry_kitti_offline.cpp:35-88`` is its de-facto config block) and
even inside kernels. Here everything is a frozen dataclass; presets reproduce
the reference's KITTI configuration bit-for-bit.

The port imports nothing of the JAX package, so it keeps this copy;
``tests/test_torch_config.py`` holds every preset equal to the reference's.
Field comments that speak of the TPU (MXU, Pallas, xprof) describe the
reference's measurements and are kept as written.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class CameraConfig:
    """Rectified stereo camera. Reference: run_odometry_kitti_offline.cpp:38-41."""

    fx: float = 718.856
    fy: float = 718.856
    cx: float = 607.1928
    cy: float = 185.2157
    baseline: float = 386.1448 / 718.856  # meters
    height: int = 376
    width: int = 1241


@dataclasses.dataclass(frozen=True)
class TrackerConfig:
    """Pose tracking. Reference: run_odometry_kitti_offline.cpp:75-88."""

    num_levels: int = 4
    # Per-level max LM iterations, index 0 = finest (level 0).
    max_iterations: Tuple[int, ...] = (10, 20, 30, 30)
    lambda_init: float = 0.01
    precision: float = 0.995
    robust: str = "huber"  # "none" | "huber" | "tdist"
    huber_delta: float = 28.0
    tdist_dof: float = 200.0  # lm_optimizer.cpp:260
    tdist_sigma_init: float = 5.0  # lm_optimizer.cpp:339
    boundary: int = 4  # pixels ignored at each border (lm_optimizer.cpp:190-191)
    min_inv_depth_valid: float = 0.01  # |d| below this is invalid (lm_optimizer.cpp:193)
    lambda_up: float = 5.0
    lambda_down: float = 5.0
    lambda_max: float = 1e5
    lambda_min: float = 1e-5
    # Warp sampling: "floor" (reference parity, integer warp), "bilinear"
    # (sub-pixel, gather-based), or "mm" (sub-pixel via gather-free MXU
    # one-hot matmuls, bf16 image quantization — the TPU-fast path; gradients
    # are bilinearly interpolated at the warp rather than nearest-gathered).
    interp: str = "floor"
    # Early termination when the LM step's twist norm falls below this
    # (0 = disabled == reference behaviour, which only stops on the
    # err ratio and so burns whole iteration budgets on sub-quantization
    # improvements). The pose cannot move perceptibly once the step is
    # well under a milliradian/millimeter.
    step_tol: float = 0.0
    # Looser step tolerance for the coarse levels (l > 0). A coarse level's
    # only job is to land inside the next level's basin (a couple of px at
    # ITS scale), so iterating it to step_tol precision is pure while-loop
    # overhead — xprof: the 4 nested LM loops' per-iteration scalar plumbing
    # was 22.7% of the r4 step. 0 = use step_tol everywhere.
    coarse_step_tol: float = 0.0
    # Brightness-affine residual r = I2(warp) - (a*I1 + b), with (a, b) a
    # closed-form masked LS fit evaluated ONCE per frame at the warm-start
    # pose and frozen for every LM iteration (DSO-style; see
    # kernels/points.fit_affine_ab for why it must not refit inside the
    # iteration). The reference's raw residual (lm_optimizer.cpp:217) biases
    # the pose under exposure drift / vignetting — real-sensor nuisances the
    # photometric nuisance fixture reproduces. Off by default = parity.
    affine_light: bool = False
    # Depth-pyramid decimation phase: "odd" reproduces the reference's
    # image/depth pyramid misalignment (see image/pyramid.py); "even" aligns.
    depth_decimation: str = "odd"
    # Execution engine: "points" extracts valid-depth pixels into
    # fixed-capacity lists once per keyframe (the TPU-fast path — gathers
    # scale with the ~5-8% of pixels that matter); "dense" computes masked
    # full-frame tensors (simpler; used for parity testing). Same math.
    engine: str = "points"
    # Max tracked points at level 0; level l capacity is this >> 2l. The
    # reference's own selection can produce at most block_rows * block_cols *
    # max_points_per_block = 16*32*80 = 40960 points, so this default is a
    # tight bound (its max_residuals=80000 is never reachable). Gather cost
    # scales with capacity — keep it snug.
    point_capacity: int = 40960
    # Capacity-truncation order: "row" = reference parity (first N valid in
    # row-major order); "spread" = 8x8 phase-interleaved enumeration, so a
    # truncated selection is a spatially uniform subsample (required when
    # point_capacity is set below the typical valid count); "blocked" = the
    # TPU-fast spatially-capped per-tile top_k (same uniformity intent as
    # spread at ~1/40 the cost — the global nonzero compaction spread/row use
    # lowers to a full-image cumsum, ~4-9 ms per call at KITTI size).
    point_order: str = "row"
    # Warm-start policy for the per-frame solve. "reference" = the previous
    # frame's pose_to_keyframe in both branches (Reset(pose_to_keyframe),
    # run_odometry_kitti_offline.cpp:261,268 — can sit a keyframe-interval of
    # flow from the optimum). "constant_velocity" extrapolates the last
    # frame-to-frame motion: T_init = inv(m) @ inv(cur) @ kf_pose.
    #
    # CAUTION: constant_velocity is UNSTABLE on weakly-conditioned scenes
    # (e.g. a single dominant plane, where the plane-induced-homography
    # ambiguity leaves flat valleys in the photometric cost). The
    # extrapolation is a two-term recurrence on past ESTIMATES, so estimate
    # noise along the degenerate directions is amplified frame over frame
    # until tracking diverges — measured: mte 0.06 -> 4.6 on a 49-frame
    # planar sequence, while "reference" warm-starting stays bounded because
    # each start inherits only ONE previous estimate and its error lies
    # mostly along well-conditioned image-flow directions. Teacher-forced
    # solves are identical from either start (the solver is not at fault);
    # closed-loop feedback is. Use only on geometry-rich scenes, and prefer
    # "reference" for anything production-facing.
    warm_start: str = "reference"


@dataclasses.dataclass(frozen=True)
class DepthConfig:
    """Stereo depth frontend. Reference: run_odometry_kitti_offline.cpp:56-70."""

    grad_th: float = 8.0
    ssd_th: float = 900.0
    photo_th: float = 15.0
    min_depth: float = 0.1  # meters
    max_depth: float = 30.0  # meters
    lambda_init: float = 0.01
    huber_delta: float = 28.0
    precision: float = 0.995
    max_iters: int = 50
    boundary: int = 4
    max_residuals: int = 80000
    # Block grid for adaptive gradient-threshold point selection
    # (depth_estimate.cpp:300-342).
    block_rows: int = 16
    block_cols: int = 32
    max_points_per_block: int = 80
    # Beyond-reference coverage floor: every block also contributes its top-k
    # gradient pixels even when the adaptive median+grad_th threshold fires
    # on nothing (weak-texture blocks; see kernels/select.py). 0 = exact
    # reference selection.
    min_points_per_block: int = 0
    min_valid_points: int = 500  # frame fails below this (depth_estimate.cpp:192)
    lambda_up: float = 10.0
    lambda_down: float = 10.0
    lambda_max: float = 1e5
    lambda_min: float = 1e-7
    # Dense search width cap. The reference searches the full epipolar segment
    # [boundary, x); max_disparity=None reproduces that. A finite cap (e.g. 128)
    # bounds compute for real-time configs.
    max_disparity: int | None = None
    # Refinement warp sampling: "floor" = reference parity (integer warp,
    # +-0.5 px systematic bias); "bilinear" = true sub-pixel refinement;
    # "mm" = sub-pixel via gather-free MXU matmuls (TPU-fast).
    interp: str = "floor"
    # Beyond-reference: left-right cycle-consistency check on the SSD winner
    # (nearly free in the cost-matrix formulation; kills accidental matches).
    lr_check: bool = False
    lr_tol: int = 1
    # Beyond-reference: Lowe-style uniqueness (ratio) test. Accept a winner
    # only when best_ssd <= ratio_test * second_best_ssd, where second-best
    # is taken outside a +-ratio_excl px exclusion window around the winner.
    # Kills ambiguous matches on (quasi-)periodic texture that pass BOTH the
    # SSD threshold and the lr check (measured on the synthetic sweep: 12-20%
    # of "valid" points carried >1 px disparity error, p99 in the hundreds of
    # px, displacing the tracker's photometric minimum ~0.1 m per frame).
    # 0 = off (reference parity).
    ratio_test: float = 0.0
    ratio_excl: int = 2
    # Beyond-reference: blockwise disparity consistency. Reject matches whose
    # disparity deviates from their selection-grid block's median matched
    # disparity by more than this many px (semi-dense depth is locally smooth
    # at the ~23x39 px block scale). 0 = off.
    block_consistency_tol: float = 0.0
    # True = reference parity: selected pixels whose SSD search failed still
    # enter refinement with inverse depth 0 (depth_estimate.cpp:388-395 with
    # the driver's zero-initialised left_dep). Because the per-pixel LM step
    # is delta ~ -r/(g(1+lambda)), weak-gradient lanes jump tens of px along
    # the epipolar line from that bogus start and land wherever the residual
    # is small — measured: such lanes are the bulk of a 12-29% >1px-error
    # fraction in the final "valid" depth. False drops unmatched lanes.
    refine_unmatched: bool = True
    # Beyond-reference: cap on |refined - search| disparity drift (px) for
    # matched lanes. Refinement is sub-pixel polish of an integer search
    # winner; a lane that wanders further found a *different* (usually
    # aliased) photometric minimum. 0 = off.
    refine_max_shift: float = 0.0
    # Refinement executor: "full" gathers from the full right image every LM
    # iteration (any interp mode; required for reference parity), "patch"
    # gathers one small window around each lane's search winner once and
    # iterates in lane math (bilinear semantics; ~10x less refine HBM
    # traffic, xprof-measured ~5 ms -> ~0.5 ms per KITTI depth run). "auto"
    # = patch exactly when its window assumption holds: sub-pixel interp,
    # matched-only lanes, drift-capped.
    refine_backend: str = "auto"
    # Beyond-reference: restrict the search to the disparity band implied by
    # [min_depth, max_depth] instead of only culling by range after refinement
    # (depth_estimate.cpp:183) — same effect, applied where it also prevents
    # accidental matches and saves compute.
    range_limited_search: bool = False
    # SSD search backend: "auto" = Pallas fused kernel on TPU, XLA elsewhere.
    search_backend: str = "auto"
    # Refinement-lane truncation order (see TrackerConfig.point_order).
    point_order: str = "row"


@dataclasses.dataclass(frozen=True)
class KeyframeConfig:
    """Keyframe promotion policy. Reference: run_odometry_kitti_offline.cpp:144-258."""

    # Weights for [|angX|, |angY|, |angZ|, |tx|, |ty|, |tz|] / 3.3
    weights: Tuple[float, ...] = (
        0.1 / 3.3,
        1.0 / 3.3,
        0.1 / 3.3,
        1.0 / 3.3,
        0.1 / 3.3,
        1.0 / 3.3,
    )
    motion_threshold: float = 1.1
    # False reproduces the reference quirk of warm-starting the tracker with
    # the OLD pose_to_keyframe even right after promoting a new keyframe
    # (Reset(pose_to_keyframe) in both branches,
    # run_odometry_kitti_offline.cpp:261,268) — the stale start can sit a full
    # keyframe-interval of flow away from the new keyframe's basin. True
    # implements the reference's own TODO (":253 set init_pose as identity"):
    # after promotion the relative pose restarts at identity.
    reset_on_promote: bool = False
    # Tracking-lost recovery policy (beyond-reference; SURVEY §5 failure
    # bullet). The reference silently returns identity on a failed solve
    # (lm_optimizer.cpp:60-65) and keeps chaining from it. With
    # relocalize=True a lost frame instead HOLDS the previous absolute pose,
    # re-seeds the keyframe from the current frame's stereo depth (when that
    # depth is healthy), restarts the tracker at identity, and marks the
    # output (StepOutput.lost) so the trajectory segment is identifiable.
    relocalize: bool = False
    # A frame is declared lost when the tracker failed outright, OR its
    # finest-level final cost exceeds lost_cost_threshold (catches garbage
    # input like an all-black frame, where the solve "succeeds" with a huge
    # residual), OR the weighted motion magnitude exceeds
    # lost_motion_threshold (catches implausible teleports). 0 disables a
    # criterion.
    lost_cost_threshold: float = 0.0
    lost_motion_threshold: float = 0.0
    # Consecutive lost frames before relocalize re-seeds the keyframe from
    # the current frame. 1 = re-seed immediately. A single bad solve is
    # often a transient (bad warm start / aliased minimum); since tracking
    # is frame-to-KEYFRAME, the next frame can still solve against the old
    # keyframe from the held-pose warm start — re-seeding immediately bakes
    # the held pose's error into the new keyframe's absolute pose forever.
    relocalize_patience: int = 1


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    camera: CameraConfig = CameraConfig()
    tracker: TrackerConfig = TrackerConfig()
    depth: DepthConfig = DepthConfig()
    keyframe: KeyframeConfig = KeyframeConfig()
    # True reproduces the reference, which runs the stereo frontend on EVERY
    # frame and discards the result unless the frame becomes a keyframe
    # (run_odometry_kitti_offline.cpp:229). False computes depth only when the
    # motion criterion nominates a keyframe (lax.cond) — identical trajectory
    # on healthy sequences, big throughput win; the only semantic difference
    # is that depth failures on never-promoted frames go unnoticed.
    depth_every_frame: bool = True


def kitti_config() -> PipelineConfig:
    """The exact configuration of the reference KITTI offline driver."""
    return PipelineConfig()


def adapt_to_camera(cfg: PipelineConfig) -> PipelineConfig:
    """Scale KITTI-tuned structural parameters to ``cfg.camera``'s image size.

    The reference asserts its input is exactly 376x1241 and hard-codes the
    16x32 selection grid and the 500-survivor guard to that size
    (``depth_estimate.cpp:37-49,300``) — any other resolution aborts. Presets
    here stay KITTI-tuned; this helper adapts them to the actual camera:
    block counts scale with each image dimension (keeping ~23x39 px blocks),
    the survivor guard scales with area, and the pyramid is capped so the
    coarsest level keeps >=12 px on the short side. At the KITTI size it is
    the identity.
    """
    cam = cfg.camera
    H, W = cam.height, cam.width
    d, t = cfg.depth, cfg.tracker
    br = max(2, min(d.block_rows, round(d.block_rows * H / 376.0)))
    bc = max(2, min(d.block_cols, round(d.block_cols * W / 1241.0)))
    mv = max(30, min(d.min_valid_points,
                     round(d.min_valid_points * (H * W) / (376.0 * 1241.0))))
    import math

    short = min(H, W)
    max_levels = max(1, int(math.log2(short / 12.0)) + 1) if short >= 12 else 1
    nl = min(t.num_levels, max_levels)
    mi = t.max_iterations[:nl]
    return dataclasses.replace(
        cfg,
        tracker=dataclasses.replace(t, num_levels=nl, max_iterations=mi),
        depth=dataclasses.replace(d, block_rows=br, block_cols=bc,
                                  min_valid_points=mv),
    )


def at_size(cfg: PipelineConfig, height: int | None = None,
            width: int | None = None) -> PipelineConfig:
    """`cfg` for a camera of `height` x `width` (either may be None: kept):
    the intrinsics scaled in proportion, then ``adapt_to_camera``. Without
    either, `cfg` unchanged. The port's tools take their reduced sizes
    through it."""
    if height is None and width is None:
        return cfg
    c = cfg.camera
    H, W = height or c.height, width or c.width
    sx, sy = W / c.width, H / c.height
    cam = dataclasses.replace(c, fx=c.fx * sx, fy=c.fy * sy, cx=c.cx * sx, cy=c.cy * sy,
                              height=H, width=W)
    return adapt_to_camera(dataclasses.replace(cfg, camera=cam))


def tum_rgbd_config(fx=525.0, fy=525.0, cx=319.5, cy=239.5) -> PipelineConfig:
    """TUM RGB-D-shaped preset (sensor-depth tracking path, test_optimizer.cpp).

    tdist_dof=5 is the standard value for robust RGB-D photometric tracking
    (Kerl et al.); the reference hard-codes nu=200 (lm_optimizer.cpp:260),
    which is nearly Gaussian and measurably non-robust to occlusions —
    set tdist_dof=200.0 for bit-parity with the reference instead.
    """
    return PipelineConfig(
        camera=CameraConfig(fx=fx, fy=fy, cx=cx, cy=cy, baseline=0.075, height=480, width=640),
        tracker=TrackerConfig(robust="tdist", tdist_dof=5.0),
    )


def accurate_config() -> PipelineConfig:
    """Improved-accuracy preset: sub-pixel warps + aligned depth pyramids.

    Fixes the reference's floor-sampling quantization (tracker + depth
    refinement) and the odd/even pyramid misalignment; everything else stays
    at the reference's tuning.
    """
    return PipelineConfig(
        # affine_light stays OFF here: measured across the 3-family sweep it
        # trades the textured family's exposure-drift tail (0.61 -> 0.10 on
        # its worst seed) for destabilizing an ambiguity-marginal clean seed
        # (plane seed 4: 0.09 -> 1.9) — enable it per-run for photometrically
        # unstable sensors (kernels/points.fit_affine_ab documents the
        # mechanism and the measurements).
        tracker=TrackerConfig(interp="bilinear", depth_decimation="even"),
        depth=DepthConfig(interp="bilinear", lr_check=True, range_limited_search=True,
                          min_points_per_block=8,
                          refine_unmatched=False, refine_max_shift=1.5,
                          block_consistency_tol=4.0),
        keyframe=KeyframeConfig(reset_on_promote=True, relocalize=True,
                                lost_cost_threshold=1000.0,
                                lost_motion_threshold=4.0,
                                relocalize_patience=2),
    )


def fast_config() -> PipelineConfig:
    """Throughput-oriented preset: bounded search, sub-pixel warps, early stops,
    lazy depth. Accuracy stays at accurate_config level (sub-pixel warps
    converge in few iterations; the step tolerance only cuts the tail)."""
    return PipelineConfig(
        # Capacity caps sit at the measured accuracy-vs-throughput knee
        # (tools/capacity_knee.py, bench workload): point_capacity
        # {2048: 0.068/324 fps, 4096: 0.064/365, 8192: 0.081/337,
        # 16384: 0.093/290} — the quality-ranked blocked extraction means
        # tighter caps keep only the strongest points, so 4096 wins BOTH
        # axes with a >2x margin to the gate.
        tracker=TrackerConfig(interp="mm", depth_decimation="even",
                              step_tol=1e-5, coarse_step_tol=2e-3,
                              point_capacity=4096,
                              point_order="blocked"),
        # Depth-side "blocked" is quality-ranked + SSD-threshold-aware
        # (kernels/points.py priority path): the per-tile cap keeps the
        # strongest-gradient matches, so it beats "spread" on BOTH axes.
        # max_residuals knee: {8192: 0.060/360 fps, 16384: 0.081/311,
        # 32768: 0.113/302}.
        # Refinement interp is "bilinear", not "mm": the stereo refinement
        # warp is ROW-LOCAL (one row per lane), so the matmul sampler's
        # full-image contraction is wasteful AND its bf16 quantization
        # measurably corrupts the depth map on weak-texture scenes (bisect:
        # driving-scene seed 4 diverges at mte 2.86 with "mm", tracks at
        # 0.101 with "bilinear"; bench cost is 402 -> 353 fps, still >10x).
        depth=DepthConfig(max_disparity=192, interp="bilinear", lr_check=True,
                          range_limited_search=True, precision=0.99,
                          max_residuals=8192, point_order="blocked",
                          min_points_per_block=8,
                          # Outlier gates (round 5): drop unmatched lanes,
                          # cap refinement drift, block-median consistency —
                          # measured to cut the >1px-error fraction of valid
                          # depth from ~17% to ~2% on weak-texture scenes
                          # (tools/diag_depth_filters.py), which was the
                          # multi-seed divergence mechanism (ACCURACY.md).
                          refine_unmatched=False, refine_max_shift=1.5,
                          block_consistency_tol=4.0),
        keyframe=KeyframeConfig(reset_on_promote=True, relocalize=True,
                                lost_cost_threshold=1000.0,
                                lost_motion_threshold=4.0,
                                relocalize_patience=2),
        depth_every_frame=False,
    )
