"""Per-stage latency of the odometry step through the port (counterpart of
``tools/profile_step.py``).

Times each stage alone after a warm-up, with a synchronise at each end:
``gaussian_image_pyramid``, the tracker (with its LM iterations per level,
coarsest first, from its ``stats``), ``compute_depth`` (with its refinement
``iters`` and ``num_valid``) and the full ``step``; then the tracker at a
fixed number of iterations per level (``precision=2.0`` never converges,
``step_tol=0.0`` never stops early), the cost of one LM iteration. Frames:
``make_scene(3, depth=14.0)`` along ``drive_trajectory(step=0.35, seed=4)``
at the configuration's camera, as the reference's tool renders them.

``--trace DIR`` also records 10 chained steps under
``utils.profiling.device_trace`` into DIR and prints ``trace_summary`` (the
traced window, device busy time and idle share, kernel launches, the
kernels that took the most device time), beside the same 10 steps timed
without the profiler (the idle share without its overhead).

Run on the card::

    python -m odometry_torch.tools.profile_step --config accurate --trace /tmp/trace

``--config`` is fast, accurate, kitti or dense (kitti_config with the dense
tracking engine); ``--device cpu`` (with ``--height``/``--width`` for a
reduced camera, through ``config.at_size``) runs it on the host, where the times are the host's.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import torch

from odometry_torch.camera.pinhole import Pinhole
from odometry_torch.config import (
    PipelineConfig,
    accurate_config,
    at_size,
    fast_config,
    kitti_config,
)
from odometry_torch.data.synthetic import drive_trajectory, make_scene, render_stereo
from odometry_torch.depth.estimator import compute_depth
from odometry_torch.device import card_line, resolve_device
from odometry_torch.image.pyramid import gaussian_image_pyramid
from odometry_torch.pipeline.odometry import OdometryState, init, step
from odometry_torch.tracking.tracker import solve_pose, solve_pose_points
from odometry_torch.utils.profiling import device_trace, synchronize, trace_summary


def dense_config() -> PipelineConfig:
    """kitti_config with the dense tracking engine."""
    cfg = kitti_config()
    return dataclasses.replace(cfg, tracker=dataclasses.replace(cfg.tracker, engine="dense"))


CONFIGS = {"fast": fast_config, "accurate": accurate_config, "kitti": kitti_config,
           "dense": dense_config}
FIXED_ITERATIONS = (1, 2, 4)
# The hand-written kernels (csrc/): a part of each one's name in a trace.
PORT_KERNELS = ("band_kernel", "band_tile_kernel", "full_kernel", "full_tile_kernel",
                "fill_keys", "finish_keys", "all_gather_kernel")
TRACE_STEPS = 10


def track(state: OdometryState, pyr_cur, cfg: PipelineConfig, tracker=None):
    """The tracker `step` runs (the point or the dense engine) on `state`'s
    keyframe and the current pyramid; `tracker` overrides cfg.tracker."""
    t = tracker or cfg.tracker
    c = cfg.camera
    cam = Pinhole.create(c.fx, c.fy, c.cx, c.cy)
    if t.engine == "points":
        return solve_pose_points(state.kf_track, pyr_cur, cam, t, state.pose_init)
    return solve_pose(state.kf_pyr, state.kf_dpyr, pyr_cur, cam, t, state.pose_init)


def level_iterations(result) -> list[int]:
    """LM iterations per level of a TrackResult, coarsest first."""
    return [int(s.iters) for s in result.stats]


def timeit(fn, reps: int) -> float:
    """ms per call of `fn` over `reps` calls after one warm-up call, with a
    synchronise on the result's devices at each end."""
    synchronize(fn())
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    synchronize(out)
    return 1e3 * (time.perf_counter() - t0) / reps


def frames_for(cfg: PipelineConfig, num_frames: int, device):
    c = cfg.camera
    cam = Pinhole.create(c.fx, c.fy, c.cx, c.cy)
    scene = make_scene(3, depth=14.0, device=device)
    return [render_stereo(scene, cam, c.baseline, T, c.height, c.width)[:2]
            for T in drive_trajectory(num_frames, step=0.35, seed=4)]


def profile(cfg: PipelineConfig, *, device="cuda", reps: int = 20, trace_dir: str | None = None,
            log=print) -> dict:
    """The stage times (ms), the tracker's and the depth frontend's counts,
    and with `trace_dir` the trace summary of TRACE_STEPS chained steps."""
    dev = resolve_device(device)
    frames = frames_for(cfg, TRACE_STEPS + 1, dev)
    state, ok = init(*frames[0], cfg, device=dev)
    left, right = frames[1]
    n = cfg.tracker.num_levels
    out = {"init_ok": bool(ok)}

    out["pyramid_ms"] = timeit(lambda: gaussian_image_pyramid(left, n, smooth=True), reps)
    pyr_cur = gaussian_image_pyramid(left, n, smooth=True)
    out["tracker_ms"] = timeit(lambda: track(state, pyr_cur, cfg), reps)
    out["tracker_iters"] = level_iterations(track(state, pyr_cur, cfg))
    out["depth_ms"] = timeit(lambda: compute_depth(left, right, cfg.camera, cfg.depth),
                             max(1, reps // 2))
    dres = compute_depth(left, right, cfg.camera, cfg.depth)
    out["depth_iters"], out["depth_num_valid"] = int(dres.iters), int(dres.num_valid)
    out["step_ms"] = timeit(lambda: step(state, left, right, cfg), reps)
    log(f"pyramid:        {out['pyramid_ms']:9.3f} ms")
    log(f"tracker:        {out['tracker_ms']:9.3f} ms   iters per level (coarse->fine): "
        f"{out['tracker_iters']}")
    log(f"depth frontend: {out['depth_ms']:9.3f} ms   iters={out['depth_iters']} "
        f"valid={out['depth_num_valid']}")
    log(f"full step:      {out['step_ms']:9.3f} ms   ({1e3 / out['step_ms']:.1f} fps)")

    out["tracker_fixed_ms"] = {}
    for k in FIXED_ITERATIONS:
        t = dataclasses.replace(cfg.tracker, max_iterations=(k,) * n, precision=2.0,
                                step_tol=0.0)
        ms = timeit(lambda: track(state, pyr_cur, cfg, t), reps)
        out["tracker_fixed_ms"][k] = ms
        log(f"tracker fixed {(k,) * n}: {ms:9.3f} ms")

    if trace_dir is not None:
        def run_steps():
            s = state
            for fl, fr in frames[1:]:
                s, o = step(s, fl, fr, cfg)
            return o.summary

        synchronize(run_steps())  # warm
        t0 = time.perf_counter()
        synchronize(run_steps())
        out["steps_ms_unprofiled"] = 1e3 * (time.perf_counter() - t0)
        with device_trace(trace_dir, device=dev) as prof:
            run_steps()
        summ = trace_summary(prof)
        summ["port_kernels"] = [op for op in trace_summary(prof, top=None)["top_device_ops"]
                                if any(k in op["name"] for k in PORT_KERNELS)]
        busy = summ["device_busy_ms"]
        summ["idle_share_unprofiled"] = 1.0 - busy / out["steps_ms_unprofiled"]
        summ["launches_per_step"] = summ["device_launches"] / TRACE_STEPS
        out["trace"] = summ
        log(f"trace of {TRACE_STEPS} steps: {json.dumps(summ)}")
        log(f"the same {TRACE_STEPS} steps without the profiler: "
            f"{out['steps_ms_unprofiled']:.3f} ms, device busy {busy:.3f} ms of it, idle share "
            f"{summ['idle_share_unprofiled']:.4f}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", choices=list(CONFIGS), default="fast")
    ap.add_argument("--trace", default=None, metavar="DIR")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--height", type=int, default=None)
    ap.add_argument("--width", type=int, default=None)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = at_size(CONFIGS[args.config](), args.height, args.width)
    where = (f"{torch.cuda.get_device_name(dev)} [{card_line(dev.index or 0)}]"
             if dev.type == "cuda" else "cpu (host)")
    print(f"profile_step --config {args.config} at {cfg.camera.height}x{cfg.camera.width} on "
          f"{where}", flush=True)
    out = profile(cfg, device=dev, trace_dir=args.trace,
                  log=lambda s: print(s, flush=True))
    print(json.dumps({"config": args.config, **out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
