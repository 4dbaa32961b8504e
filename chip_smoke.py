"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

Phases, each of which raises on failure (so the script exits non-zero and
prints no result line):

1. the card's name and power limit (nvidia-smi), torch and CUDA versions;
2. build the three kernels from ``odometry_torch/csrc`` with nvcc, one
   process each, started together (the band kernel B1, the full-search
   kernel B2 and the all-gather B3), and print what ``-Xptxas -v`` says;
3. every case of the parity harness ``odometry_torch/tools/kernel_parity.py``:
   ``tools/tpu_parity.py``'s band, full and dense cases at its sizes; each
   SSD kernel against its plain PyTorch version on selected pixels and on
   dense every-pixel winner maps at the presets' bands at KITTI size, and
   one ``second_best`` case each, under that module's parity budgets; B1 and
   B2 against their plain version bit for bit on ``tie_stereo_pair`` images
   (exact SSDs, exact ties; B1 also on a band narrower than its blocking's
   spread and at widths that are not a multiple of 128), and B2 with
   ``max_disparity=192`` against B1 bit for bit at KITTI size (both score
   pairs with ``ssd8.cuh``);
4. kernel and plain-version times at the KITTI shape: B1 on fast_config's
   band (and B2 on the same band beside it), B2 on the full search and on
   accurate_config's band [12, 1241], each as the device time of
   back-to-back calls and as CUDA events around one call (which also hold
   the host's enqueue); and B1 and B2 on a batch of 3 frames in one call
   beside 3 single calls and the bound for the batch;
5. the fast_config odometry path end to end at 376x1241 (the workload of
   ``bench.py``, through ``odometry_torch/tools/bench.py``): 3 trajectory
   seeds x 49 frames rendered on the card with the texture phase rounded as
   bench.py's TPU rounded it (``tpu_phase_scene``), the median
   mean-translation-error gate of ``bench.py`` (< 0.15), B1's launch count
   against the number of depth runs, and no launch of B2; then bench.py's
   timed loop on seed 4's frames and its JSON line, B1 once per depth run;
6. accurate_config end to end at 376x1241 on the driving family of
   ``tools/accuracy_sweep.py`` (3 seeds x 49 frames): the same gate, B2's
   launches against the depth runs (every frame), no launch of B1;
7. kitti_config end to end at 376x1241 on seed 4 of that family (49 frames):
   every state tensor on the card, B2's launches against the depth runs;
8. the dense tracking engine: kitti_config with ``engine="dense"``, seed 4,
   10 frames, B2's launches against the depth runs;
9. the all-gather kernel B3 against its plain version (the ring's schedule)
   and ``torch.cat``, bit for bit, on meshes of 1 to 8 virtual ranks of the
   card, shards of float32, float16 and int8 and at a 4-byte storage offset,
   each case in one launch and with ``force_route="per_shard"`` (one launch
   per shard: the host side of the route across cards, its tables, offsets
   and events), the full width (8 ranks of 7 x 16384 float32) 200 times back
   to back, and the kernel, plain-version and ``torch.cat`` times beside the
   bound at full width and above the L2 (8 ranks of 7 x 131072 float32);
10. the sweep: ``run_sweep`` of fast_config over phase 5's frames (a) on
    ``sequence_mesh(3)`` (three virtual ranks of the card, one sequence
    each) and (b) on ``sequence_mesh(1)`` (one rank stepping the three as
    one batch, ``step_batch``), each gated as phase 5 with ``global_ok`` on
    every frame and B1 launched once per depth run of a rank (for (b): init
    and each step with a keyframe candidate in the batch), (b) also on
    ``run_sequence``'s keyframes (the largest per-frame translation gap
    printed) and on fewer host reads per step than (a) (counted with
    ``torch.cuda.set_sync_debug_mode``); one keyframe store per sequence
    filled as ``run_slam`` fills it (frame 0 and every promotion); (c) the
    KITTI sweep's 22 sequences (the driving family, 13 frames each at
    376x1241) batched on one rank and in turn on 22, in turns batched, in
    turn, batched: sequence-frames/s, peak device memory, median mte (gate
    < 0.15), ``global_ok`` frames;
11. the stores' BA windows: the ring on their window poses and point blocks
    (bit for bit against the plain version), ``ba_solve`` motion-only (as
    ``run_slam`` runs it) and with free depths, and ``ba_solve_sharded`` on
    ``grid_mesh(1, 8)``: motion-only held to ``ba_solve`` within 2e-4 (poses)
    and 1e-4 (inverse depths), free depths on cost and finiteness (ROADMAP
    C9);
12. ``run_slam`` at 376x1241 on the loop fixture of
    ``odometry_torch/tools/verify_loop_closure.py`` (fast_config with
    ``motion_threshold=0.4``, ``make_driving_scene(3, side_x=20, wall_z=26)``,
    49 frames out and back in steps of 0.35 m), odometry only and with BA
    every 2 keyframes and loop closure: the tool's JSON line, its gates (no
    depth failure, at least one closure, a SLAM endpoint error below 0.2 m
    and no larger than the odometry's) and ``OK``, B1 launched once per depth
    run and B2 and B3 never;
13. the command line, ``odometry_torch.cli.main`` with ``--device cuda``, on
    directories written with ``data/png.py`` from the driving family (seed 4,
    25 frames at 376x1241, 8-bit): ``run-kitti --config accurate`` with its
    pose and keyframe exports (mte < 0.15, B2 once per frame, B1 never), a
    checkpointed run of 13 frames resumed to 25 (the uninterrupted run's
    keyframes, poses within 1e-5, the checkpoint's keys and arrays those of
    the same state written from the CPU), ``run-kitti --config fast
    --lazy-depth`` (mte < 0.15, B1 once per depth run, B2 never),
    ``eval-disparity`` on a Middlebury-layout pair of frame 0 (B2 once,
    ``frame_ok``), ``run-tum`` on 10 frames at 480x640 with 16-bit depth (no
    SSD launch), ``run-live`` on a directory of 5 pairs (5 lines, B1 at least
    once), and ``run_sequence(debug_checks=True)`` raising at frame 2 on a NaN
    input; it prints the PNG write and decode times and which decoder
    ``stereo_frames`` used (the native one held bit for bit to
    ``data/png.py``);
14. the port's tools: (a) ``tools/accuracy_sweep.sweep`` on seed 3, the
    three scene families x fast_config and accurate_config, 49 frames at
    376x1241 (plane and driving gated at mte < 0.15, textured on no depth
    failure; B1 once per depth run and B2 never on fast, B2 once per frame
    and B1 never on accurate); (b) ``sweep_scaling_report(fast_config(),
    [1, 2, 4, 8])`` printed with ``format_scaling_table`` (analytic
    efficiency >= 80%, 0 < collective bytes < 4096); (c) ``tools/profile_step``
    on accurate_config with a device trace of 10 steps into ``$TMPDIR``
    (``trace_summary`` printed; gated on device time, launches and B2 in the
    trace);
15. the reference's diagnostic tools through ``odometry_torch/tools/``, each
    cut: ``capacity_knee`` on one row of each sweep (cap 2048, max_residuals
    32768) on phase 5's seed-4 frames, ``diag_divergence`` on fast/plane and
    accurate/driving seed 4, ``diag_basin`` on seed 11 with 2 variants,
    ``diag_depth`` on plane/fast and driving/accurate seed 4,
    ``diag_depth_decomp`` on one seed, ``diag_depth_filters`` on 2 variants
    and ``bisect_fast_robustness`` on 1 variant x 2 cases; each gated on
    finite output and on its launches (B1 once per depth run and B2 never on
    fast_config, B2 once per depth run and B1 never on accurate_config);
16. the reference's measuring tools through ``odometry_torch/tools/``:
    ``roofline`` (four rows against their bounds; efficiency at most 105%
    unless the row's bytes fit the L2), ``microbench`` (the lm suite at
    N = 8192 and 40960 with both samplers, one point count of the gather
    and sample suites, the pyramid, depth and step suites; every time finite
    and above 0; one replay of the captured lm body gives the eager call's
    delta bit for bit), ``verify_mm`` (its runs and gates, ``VERIFY OK``),
    ``trace_step`` of 21 steps and of 10 ``compute_depth`` calls (SSD
    kernels in each trace) and ``preflight --quick`` (bench in a process of
    its own); B1 once per SSD search the tools make in this process and B2
    only in verify_mm's kitti_config run, once per frame;
17. the port on several cards, ``odometry_torch/tools/multichip.py``'s
    (a)-(e) when 2 cards or more are visible (the sweep in one process and
    in one process per card, the ring and sharded BA across the cards, B3
    across cards with its times, the scaling report over the cards); with
    one card, one line saying it did not run and why; with several cards
    also (b) on the global mesh and (c)/(d) across one process per card;
18. the port across processes on one card: two processes of
    ``tools/multichip.py`` share it (a gloo group; B3 between them through
    CUDA IPC), each running ``run_sweep`` of 2 driving sequences (seeds 0, 1
    and 2, 3; 49 frames at 376x1241, fast_config) on the global
    ``sequence_mesh()`` of 2 ranks, then B3 across them on phase 11's window
    poses and point blocks, every phase-9 ring case of 2 ranks or more, 200
    gathers with ``torch.cuda.empty_cache()`` after every 7th, and
    ``ba_solve_sharded`` over ``grid_mesh(1, 2)`` on phase 11's first store
    (motion-only and free depths); gated on each process's lanes equal to
    one process's run of the same sequences on ``sequence_mesh(2)``, B3 bit
    for bit against plain and ``torch.cat``, the sharded BA equal to one
    process's over 2 ranks, bit for bit, and the children's B1 and B3
    launches (added to the kernels line); times per gather across the
    processes at 2 x (7, 16384) and 2 x (7, 131072) float32 beside the
    bound and the same gather in one process.

Phases 1-16 and 18 run on the first card (``CARD``); phase 17 takes every
card.

Phase 3's harness also holds the tiled route of B1 and B2 (rows too wide
for one block's shared memory, ROADMAP C10) bit for bit against the plain
version at 8x6000 and against the one-block route at 376x1241; phase 4
times it at 376x6000 and 376x1241 (reported, not gated).

Each path's launch counts are set to 0 just before it runs and read just
after; a call on the tiled route counts its three launches. The second-to-last line is a JSON object describing each kernel; the
last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
import shutil
import sys
import tempfile
import time
import warnings

import numpy as np
import torch

from odometry_torch import cli, interop
from odometry_torch.camera.pinhole import Pinhole
from odometry_torch.config import accurate_config, fast_config, kitti_config, tum_rgbd_config
from odometry_torch.data import kitti, png, tum
from odometry_torch.data.synthetic import (  # noqa: F401 (tpu_phase_scene: tests read it here)
    drive_trajectory,
    make_driving_scene,
    render_stereo,
    tpu_phase_scene,
)
from odometry_torch.device import card_line
from odometry_torch.distributed import ring_exchange
from odometry_torch.distributed.ba_dist import ba_solve_sharded
from odometry_torch.distributed.mesh import grid_mesh, sequence_mesh
from odometry_torch.distributed.scaling import format_scaling_table, sweep_scaling_report
from odometry_torch.distributed.sweep import run_sweep, sequence_view
from odometry_torch.eval.export import load_kitti_poses, save_kitti_poses
from odometry_torch.eval.metrics import mean_translation_error
from odometry_torch.kernels import _build, disparity_band, disparity_full
from odometry_torch.mapping.ba import BAConfig, BAProblem, ba_solve
from odometry_torch.mapping.keyframe import create_store, insert_keyframe, window_slots
from odometry_torch.pipeline import odometry as odometry_module
from odometry_torch.pipeline import runner
from odometry_torch.pipeline.odometry import init, step
from odometry_torch.pipeline.runner import run_sequence
from odometry_torch.tools import (
    accuracy_sweep,
    bench,
    bisect_fast_robustness,
    capacity_knee,
    diag_basin,
    diag_depth,
    diag_depth_decomp,
    diag_depth_filters,
    diag_divergence,
    kernel_parity,
    microbench,
    multichip,
    preflight,
    profile_step,
    roofline,
    trace_step,
    verify_loop_closure,
    verify_mm,
)
from odometry_torch.tools.kernel_parity import KERNELS, KITTI, MIN_D, W_KITTI, stereo
from odometry_torch.tools.multichip import RING_CASES, RING_REPEATS, ring_bound_ms
from odometry_torch.tools.roofline import search_bound
from odometry_torch.utils.checkpoint import load_pytree, save_pytree
from odometry_torch.utils.debug import DebugCheckError
from odometry_torch.utils.profiling import capture, device_ms

# Phases 1-16 run on the first card: "cuda" with no index names every
# visible card (ROADMAP C16), and the meshes of these phases are the
# virtual ranks of one card. Phase 17 takes every card.
CARD = "cuda:0"

# Where the tiled route is timed beside the plain version.
WIDE_TIMING = (376, 6000)
def _tiled_timing(card):
    """The tiled route's device times (reported, not gated): at WIDE_TIMING
    beside the plain version and the bound, and forced at KITTI size beside
    the one-block route, in turns (one-block, tiled, tiled, one-block)."""
    for kernel, max_d, label in (("band", 192, "band [12, 192] lr"),
                                 ("full", None, "full search lr")):
        fn, plain = KERNELS[kernel]
        kw = dict(boundary=4, min_disparity=MIN_D if kernel == "band" else None,
                  max_disparity=max_d, lr=True)
        H, W = WIDE_TIMING
        ls, rs = stereo(H, W, 0)
        wide_ms = device_ms(lambda: fn(ls, rs, **kw), 10)
        wide_plain_ms = device_ms(lambda: plain(ls, rs, **kw), 2)
        bound_ms, bound_by = search_bound(H, W, 4, kw["min_disparity"], max_d, True)
        print(f"timing {H}x{W} {kernel} {label} (tiled route, {disparity_band.TILED_LAUNCHES} "
              f"launches per call): kernel {wide_ms:.4f} ms, plain {wide_plain_ms:.4f} ms, bound "
              f"{bound_ms:.4f} ms ({bound_by}), {100 * bound_ms / wide_ms:.1f}% of it (device "
              f"time of back-to-back calls) [{card}]", flush=True)
        ls, rs = stereo(*KITTI, 0)
        runs = {r: (lambda r=r: fn(ls, rs, force_route=r, **kw))
                for r in (disparity_band.ONE_BLOCK, disparity_band.TILED)}
        order = list(runs) + list(runs)[::-1]
        times = {r: [] for r in runs}
        for r in order:
            times[r].append(device_ms(runs[r], 50))
        shown = ", ".join(f"{r} " + " / ".join(f"{t:.4f}" for t in v) for r, v in times.items())
        print(f"timing {KITTI[0]}x{KITTI[1]} {kernel} {label}: {shown} ms (device time of "
              f"back-to-back calls, in turns {'-'.join(order)}) [{card}]", flush=True)


BATCH_TIMING = 3  # images of the batched timing at KITTI size


def _batch_timing(card):
    """A batch of BATCH_TIMING frames at KITTI size in one call against one
    call per frame (device time of back-to-back calls, in turns batched,
    single, single, batched), beside the bound for the batch's work (the
    batch's pairs and bytes, BATCH_TIMING x one frame's). Returns {kernel:
    (batched ms, single ms for the batch, bound ms, bound_by)}."""
    out = {}
    B = BATCH_TIMING
    for kernel, max_d, label in (("band", 192, "band [12, 192] lr"),
                                 ("full", None, "full search lr")):
        fn, _ = KERNELS[kernel]
        kw = dict(boundary=4, min_disparity=MIN_D if kernel == "band" else None,
                  max_disparity=max_d, lr=True)
        ls, rs = kernel_parity.batch_images((B, *KITTI), "frames")
        runs = {"batched": lambda: fn(ls, rs, **kw),
                "single": lambda: [fn(a, b, **kw) for a, b in zip(ls, rs)]}
        times = {r: [] for r in runs}
        for r in ("batched", "single", "single", "batched"):
            times[r].append(device_ms(runs[r], 20))
        one_ms, bound_by = search_bound(*KITTI, 4, kw["min_disparity"], max_d, True)
        bound_ms = B * one_ms
        batched, single = (float(np.median(times[r])) for r in ("batched", "single"))
        print(f"timing batch {B}x{KITTI[0]}x{KITTI[1]} {kernel} {label}: one batched call "
              f"{' / '.join(f'{t:.4f}' for t in times['batched'])} ms, {B} single calls "
              f"{' / '.join(f'{t:.4f}' for t in times['single'])} ms (device time of "
              f"back-to-back calls, in turns batched-single-single-batched); bound for the "
              f"batch {bound_ms:.4f} ms ({bound_by}), {100 * bound_ms / batched:.1f}% of it "
              f"[{card}]", flush=True)
        out[kernel] = (batched, single, bound_ms, bound_by)
    return out


def _time_ms(fn, reps):
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def _timing(kernel, label, kw, card):
    """Kernel and plain-version times at the KITTI shape: device time per call
    of back-to-back calls (`device_ms`, the kernels line's numbers), and the
    median of CUDA events around single calls, which also holds the host's
    enqueue (ctypes, the output allocations). For B1 also B2's device time on
    the same band, the port's other kernel for it (not a library call)."""
    fn, plain = KERNELS[kernel]
    ls, rs = stereo(*KITTI, 0)
    for _ in range(3):
        fn(ls, rs, **kw)
        plain(ls, rs, **kw)
    ms = device_ms(lambda: fn(ls, rs, **kw), 50)
    plain_ms = device_ms(lambda: plain(ls, rs, **kw), 5)
    ev_ms = _time_ms(lambda: fn(ls, rs, **kw), 21)
    ev_plain_ms = _time_ms(lambda: plain(ls, rs, **kw), 7)
    bound_ms, bound_by = search_bound(*KITTI, kw["boundary"], kw["min_disparity"],
                                kw["max_disparity"], kw["lr"])
    beside = ""
    if kernel == "band":
        full_ms = device_ms(lambda: disparity_full.disparity_full(ls, rs, **kw), 50)
        beside = f"; B2 on the same band {full_ms:.4f} ms (device time)"
    print(f"timing {KITTI[0]}x{KITTI[1]} {kernel} {label}: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms (device time of back-to-back calls); kernel {ev_ms:.4f} ms, plain "
          f"{ev_plain_ms:.4f} ms (median of CUDA events around one call, host enqueue "
          f"included); bound {bound_ms:.4f} ms ({bound_by}), {100 * bound_ms / ms:.1f}% of it"
          f"{beside} [{card}]", flush=True)
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)


def _per_call(cfg) -> int:
    """Launches one SSD search of `cfg`'s depth runs makes: 1 on the
    one-block route, TILED_LAUNCHES on the tiled (rows too wide for one
    block)."""
    one = disparity_band.route(cfg.camera.width, cfg.depth.lr_check) == disparity_band.ONE_BLOCK
    return 1 if one else disparity_band.TILED_LAUNCHES


def _reset_counts():
    disparity_band.LAUNCHES = 0
    disparity_full.LAUNCHES = 0
    ring_exchange.LAUNCHES = 0


def _counts():
    """(B1, B2, B3) launches since the last reset."""
    return disparity_band.LAUNCHES, disparity_full.LAUNCHES, ring_exchange.LAUNCHES


def _state_leaves(state) -> list:
    """Every tensor of an OdometryState, nested tuples included."""
    leaves = []

    def collect(v):
        if isinstance(v, torch.Tensor):
            leaves.append(v)
        elif isinstance(v, tuple):
            for u in v:
                collect(u)

    for f in dataclasses.fields(state):
        collect(getattr(state, f.name))
    return leaves


def _check_state_on_card(frames, cfg):
    """Every state tensor lives on the card after init and a step."""
    state, ok = init(*frames[0], cfg, device="cuda")
    state, _ = step(state, *frames[1], cfg)
    leaves = _state_leaves(state)
    if not leaves or not all(t.is_cuda for t in leaves):
        raise RuntimeError("a state tensor is not on the card")
    print(f"state: {len(leaves)} tensors, all on {leaves[0].device}", flush=True)


@contextlib.contextmanager
def _depth_calls(*modules, names=("compute_depth",)):
    """Counts the calls made through `modules` (``pipeline.odometry`` by
    default) to the functions of `names` that each holds (``compute_depth``
    by default; each call is one SSD search) while active. Yields a one-item
    list."""
    modules = modules or (odometry_module,)
    calls = [0]
    real = [(m, name, getattr(m, name)) for m in modules for name in names if hasattr(m, name)]

    def counted(fn):
        def wrapper(*a, **k):
            calls[0] += 1
            return fn(*a, **k)
        return wrapper

    for m, name, fn in real:
        setattr(m, name, counted(fn))
    try:
        yield calls
    finally:
        for m, name, fn in real:
            setattr(m, name, fn)


def _e2e(card):
    """fast_config at KITTI size through the port's run_sequence, on the card:
    bench.py's workload, gate and timed loop through ``tools/bench.py``."""
    cfg = fast_config()
    runs = [(seed, *bench.render_frames(cfg, seed, device="cuda")) for seed in bench.SEEDS]

    _reset_counts()  # count this path's launches only
    records = bench.accuracy(cfg, runs, device="cuda")
    launches, full_launches, _ = _counts()

    depth_runs = sum(r["depth_runs"] for r in records)
    for r in records:
        res = r["result"]
        ms = float(np.median(res.per_frame_ms))
        # The reference's eval_pose metric (run_odometry_kitti_offline.cpp:
        # 361-372): mean unaligned translation error.
        print(f"e2e seed={r['seed']}: frames={res.num_frames} mte={r['mte']:.6f} "
              f"keyframes={len(res.keyframe_ids)} lost={len(res.lost_ids)} "
              f"fps={res.fps:.3f} median_ms_per_frame={ms:.3f} [{card}]", flush=True)
    med = bench.check_gate([r["mte"] for r in records])
    print(f"e2e median mte={med:.6f} (gate < {bench.GATE}); band-kernel launches={launches}, "
          f"full-search launches={full_launches}, depth runs={depth_runs}", flush=True)
    if launches == 0 or launches != depth_runs * _per_call(cfg):
        raise RuntimeError(f"band kernel launches {launches} != depth runs {depth_runs}")
    if full_launches != 0:
        raise RuntimeError(f"fast_config launched the full-search kernel {full_launches} times")
    _check_state_on_card(runs[0][2], cfg)

    # bench.py's timed loop on the timed seed's frames.
    frames = next(frames for seed, _, frames in runs if seed == bench.TIMED_SEED)
    _reset_counts()
    with _depth_calls() as calls:
        fps, steps = bench.timed_fps(cfg, frames, device="cuda")
    timed_band, timed_full, _ = _counts()
    line = bench.result_line(fps)
    print(json.dumps(line), flush=True)
    print(f"bench: {steps} timed steps of seed {bench.TIMED_SEED} (after init and 3 warm-up "
          f"steps), {fps:.3f} frames/s, {1e3 / fps:.3f} ms per frame; band-kernel launches="
          f"{timed_band}, full-search launches={timed_full}, depth runs={calls[0]} [{card}]",
          flush=True)
    if timed_band != calls[0] * _per_call(cfg) or timed_full != 0 or not np.isfinite(fps):
        raise RuntimeError(f"bench timed loop: launches B1 {timed_band} B2 {timed_full}, depth "
                           f"runs {calls[0]}, fps {fps}")
    return launches + timed_band, runs, [r["result"] for r in records]


def _driving_frames(seeds, num_frames, cfg):
    """The driving family of tools/accuracy_sweep.py:75-78, rendered on the
    card: make_driving_scene(s, side_x=20, wall_z=26), drive_trajectory(
    num_frames, step=0.25, seed=s)."""
    c = cfg.camera
    cam = Pinhole.create(c.fx, c.fy, c.cx, c.cy)
    out = {}
    for seed in seeds:
        scene = make_driving_scene(seed, side_x=20.0, wall_z=26.0, device="cuda")
        poses = drive_trajectory(num_frames, step=0.25, seed=seed)
        out[seed] = (poses, [render_stereo(scene, cam, c.baseline, T, c.height, c.width)[:2]
                             for T in poses])
    torch.cuda.synchronize()
    return out


def _run_full_search_path(name, cfg, runs, card, **run_kw):
    """Drive one every-frame-depth path through run_sequence on the card with
    the launch counts set to 0 just before; return (mtes, results, B1
    launches, B2 launches). B2 must launch once per frame, counting init, and
    B1 never."""
    _reset_counts()
    results = [(seed, poses, run_sequence(frames, cfg, device="cuda", **run_kw))
               for seed, (poses, frames) in runs.items()]
    band_launches, full_launches, _ = _counts()
    depth_runs = sum(res.num_frames for _, _, res in results)
    mtes = []
    for seed, poses, res in results:
        mte = mean_translation_error(poses[: res.num_frames], res.poses)
        mtes.append(mte)
        ms = float(np.median(res.per_frame_ms))
        print(f"{name} seed={seed}: frames={res.num_frames} mte={mte:.6f} "
              f"failed_at={res.failed_at} keyframes={len(res.keyframe_ids)} "
              f"lost={len(res.lost_ids)} fps={res.fps:.3f} median_ms_per_frame={ms:.3f} "
              f"[{card}]", flush=True)
    print(f"{name}: full-search launches={full_launches}, band launches={band_launches}, "
          f"depth runs={depth_runs}", flush=True)
    if full_launches == 0 or full_launches != depth_runs * _per_call(cfg):
        raise RuntimeError(f"{name}: full-search launches {full_launches} != depth runs "
                           f"{depth_runs}")
    if band_launches != 0:
        raise RuntimeError(f"{name}: launched the band kernel {band_launches} times")
    return mtes, results, full_launches


def _e2e_full_search(card):
    """accurate_config (3 seeds, gated), kitti_config and the dense engine
    (seed 4) at 376x1241 on the driving family, all through B2."""
    acc = accurate_config()
    runs = _driving_frames((4, 5, 11), 49, acc)
    mtes, results, launches_acc = _run_full_search_path("accurate_config", acc, runs, card)
    med = float(np.median(mtes))
    print(f"accurate_config median mte={med:.6f} (gate < 0.15; the reference's "
          f"accurate/driving median over 5 seeds on TPU-rendered frames was 0.0431, "
          f"ACCURACY.md, an accuracy figure only)", flush=True)
    for seed, _, res in results:
        if res.failed_at is not None:
            raise RuntimeError(f"accurate_config seed {seed}: depth failed at frame "
                               f"{res.failed_at}")
    if not med < 0.15:
        raise RuntimeError(f"accurate_config median mte {med} fails the gate 0.15 ({mtes})")

    kitti = kitti_config()
    seed4 = {4: runs[4]}
    _, _, launches_kitti = _run_full_search_path("kitti_config", kitti, seed4, card,
                                                 stop_on_depth_failure=False)
    _check_state_on_card(runs[4][1], kitti)

    dense = dataclasses.replace(kitti, tracker=dataclasses.replace(kitti.tracker,
                                                                   engine="dense"))
    seed4_10 = {4: (runs[4][0][:10], runs[4][1][:10])}
    _, _, launches_dense = _run_full_search_path("kitti_config dense engine", dense, seed4_10,
                                                 card, stop_on_depth_failure=False)
    _check_state_on_card(runs[4][1], dense)
    return launches_acc + launches_kitti + launches_dense

# Phase 9 runs tools/multichip.py's RING_CASES and RING_REPEATS on the
# virtual ranks of one card, each case on both routes.
# A timing case above the 50 MB L2: 8 ranks of 7 x 131072 float32, 264 MB.
RING_ABOVE_L2 = (8, (7, 131072))


def _ring_shards(num, shape, dtype, offset, g):
    n = int(np.prod(shape))
    if dtype.is_floating_point:
        base = [torch.randn(n + offset, generator=g, device="cuda").to(dtype)
                for _ in range(num)]
    else:
        base = [torch.randint(-128, 128, (n + offset,), generator=g, device="cuda").to(dtype)
                for _ in range(num)]
    return [b[offset:].view(shape) for b in base]


def _ring_timing(shards, card, reps):
    """Kernel, plain-version and torch.cat x num device times of one all-gather
    of `shards`, beside the bound."""
    num = len(shards)
    nbytes = shards[0].numel() * shards[0].element_size()
    ms = device_ms(lambda: ring_exchange.ring_gather(shards), reps)
    plain_ms = device_ms(lambda: ring_exchange.ring_gather_plain(shards), 5)
    library_ms = device_ms(lambda: [torch.cat(shards) for _ in range(num)], reps)
    # Least bytes an all-gather on one card moves: every shard read once,
    # every rank's output written once (multichip.ring_bound_ms, which also
    # bounds the all-gather across cards by NVLink).
    moved = num * nbytes + num * num * nbytes
    bound_ms = ring_bound_ms([s.device for s in shards], nbytes)
    print(f"timing ring ranks={num} shard={tuple(shards[0].shape)} {shards[0].dtype}: kernel "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms, torch.cat x{num} {library_ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms (bytes: {moved} B), {100 * bound_ms / ms:.1f}% of it (device time "
          f"of back-to-back calls, CUDA events) [{card}]", flush=True)
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by="bytes",
                library_ms=library_ms)


def _ring_phase(card):
    """Phase 9: B3 against its plain version and torch.cat, bit for bit, on
    one launch and, forced with ``force_route="per_shard"``, on one launch
    per shard (the multi-card route's host side); RING_REPEATS back-to-back
    launches at full width; times at full width and above the L2. Returns
    (full-width timing entry, [max |kernel - plain| per case])."""
    g = torch.Generator(device="cuda").manual_seed(9)
    errs = []
    for num, shape, dtype, offset in RING_CASES:
        shards = _ring_shards(num, shape, dtype, offset, g)
        outs = ring_exchange.ring_all_gather(shards, sequence_mesh(num, CARD), axis="seq")
        torch.cuda.synchronize()
        plain = ring_exchange.ring_gather_plain(shards)
        full = torch.cat(shards)
        ok = all(torch.equal(o, p) and torch.equal(o, full) for o, p in zip(outs, plain))
        errs.append(max(float((o.double() - p.double()).abs().max()) for o, p in zip(outs, plain)))
        label = f"ring ranks={num} shard={shape} {dtype} offset={offset}"
        print(f"{'PASS' if ok else 'FAIL'}  {label}: bitwise vs plain and torch.cat, "
              f"max|diff|={errs[-1]}", flush=True)
        if not ok:
            raise RuntimeError(f"ring_gather differs from its plain version at {label}")
        ok, err, launches = multichip.check_ring(shards, "per_shard")
        errs.append(err)
        print(f"{'PASS' if ok and launches == num else 'FAIL'}  {label} route=per_shard: "
              f"bitwise vs plain and torch.cat, max|diff|={err}, launches {launches} (one per "
              "shard)", flush=True)
        if not ok or launches != num:
            raise RuntimeError(f"ring_gather's per_shard route fails at {label}")

    # The full-width case (the last, whose shards these are) RING_REPEATS
    # times back to back, no host read between launches; every output is
    # compared on the card.
    bad = torch.zeros((), dtype=torch.int64, device="cuda")
    for _ in range(RING_REPEATS):
        outs = ring_exchange.ring_gather(shards)
        bad = bad + torch.stack([(o != full).any() for o in outs]).sum()
    print(f"ring: {RING_REPEATS} back-to-back launches at ranks={num} shard={shape}: "
          f"{int(bad)} outputs differ", flush=True)
    if int(bad) != 0:
        raise RuntimeError(f"ring_gather: {int(bad)} outputs of {RING_REPEATS} repeats differ")

    timing = _ring_timing(shards, card, 100)
    num, shape = RING_ABOVE_L2
    _ring_timing([torch.randn(shape, generator=g, device="cuda") for _ in range(num)], card, 20)
    return timing, errs


def _state_devices_ok(states, mesh) -> bool:
    """Every tensor of each rank's state on that rank's device of the card."""
    return all(leaves and all(t.is_cuda and t.device == dev for t in leaves)
               for leaves, dev in zip(map(_state_leaves, states), mesh.axis_devices("seq")))


class _HostReads:
    """Counts the host reads (device-to-host synchronisations: ``bool`` of a
    card tensor, ``.cpu()``, ``nonzero``) made while it is active, through
    ``torch.cuda.set_sync_debug_mode``, which turns each into a warning."""

    def __enter__(self):
        self._catch = warnings.catch_warnings(record=True)
        self._log = self._catch.__enter__()
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        return self

    def __exit__(self, *exc):
        torch.cuda.set_sync_debug_mode(0)
        self._catch.__exit__(*exc)

    @property
    def count(self) -> int:
        return sum("synchroniz" in str(w.message) for w in self._log)


def _sweep_run(cfg, frames_per_seq, mesh):
    """run_sweep of `frames_per_seq` on `mesh` with the launch counts set to
    0 just before and the host reads counted, filling one keyframe store per
    sequence as run_slam does (pipeline/slam.py:124-128,200-205) from its
    ``sequence_view``. Returns a dict: poses, summaries (per sequence), health,
    stores, final states, seconds, launches (B1, B2, B3), host reads of the
    init, of the steps (the progress callback's own reads excluded)."""
    c = cfg.camera
    S = len(frames_per_seq)
    summaries = [[] for _ in range(S)]
    health, stores, final = [], [], []
    paths = [[0.0, None] for _ in range(S)]  # trajectory length, last position
    marks = {"init": 0, "callback": 0}

    def on_frame(i, states, outs, global_ok):
        entry = reads.count
        if outs is None:
            marks["init"] = entry
        health.append(bool(global_ok))
        final[:] = [states]
        for s in range(S):
            state = sequence_view(states, s)
            kf = state.kf_track[0]
            if outs is None:
                stores.append(insert_keyframe(
                    create_store(32, cfg.tracker.point_capacity, c.height, c.width,
                                 device=state.kf_pose.device),
                    kf.pts, kf.intensity, state.kf_pose, 0, image=state.kf_pyr[0]))
                paths[s][1] = np.zeros(3, np.float32)
                continue
            summ = sequence_view(outs, s).summary.cpu().numpy()
            summaries[s].append(summ)
            pos = summ[:16].reshape(4, 4)[:3, 3]
            paths[s][0] += float(np.linalg.norm(pos - paths[s][1]))
            paths[s][1] = pos
            if summ[32] > 0.5:  # promoted
                stores[s] = insert_keyframe(stores[s], kf.pts, kf.intensity, state.kf_pose, i,
                                            image=state.kf_pyr[0], path=paths[s][0])
        marks["callback"] += reads.count - entry

    _reset_counts()  # count this path's launches only
    with _HostReads() as reads:
        t0 = time.perf_counter()
        poses = run_sweep(frames_per_seq, cfg, mesh, progress=on_frame)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        total = reads.count
    return dict(poses=poses, summaries=[np.stack(x) for x in summaries], health=health,
                stores=stores, final=final[0], seconds=seconds, launches=_counts(),
                init_reads=marks["init"], step_reads=total - marks["init"] - marks["callback"])


def _depth_runs(summaries) -> np.ndarray:
    """(frames, S) bool: sequence s ran depth at step i (survivors or a
    failed depth); init is not in it."""
    return np.stack([(sm[:, 37] > 0) | (sm[:, 34] < 0.5) for sm in summaries], axis=1)


def _sweep_phase(card, runs, single_results):
    """Phase 10: phase 5's frames swept (a) on sequence_mesh(3), one sequence
    per virtual rank of the card, and (b) on sequence_mesh(1), one rank
    stepping the three as one batch; each gated as phase 5, global_ok on
    every frame; (b) also on run_sequence's keyframes, B1 launched once per
    batched depth run, and fewer host reads per step than (a)'s. Then (c),
    the KITTI sweep's 22 sequences batched and in turn (:func:`_kitti_sweep`).
    Returns (a)'s keyframe stores, one per sequence, and the B1 launches of
    (b) and (c)."""
    cfg = fast_config()
    frames_per_seq = [frames for _, _, frames in runs]
    num_frames = len(frames_per_seq[0])
    layouts = {"(a) one per rank": sequence_mesh(len(runs), CARD),
               "(b) one batch": sequence_mesh(1, CARD)}
    results = {name: _sweep_run(cfg, frames_per_seq, mesh) for name, mesh in layouts.items()}
    for name, mesh in layouts.items():
        r = results[name]
        band, full, ring = r["launches"]
        ran = _depth_runs(r["summaries"])
        # One depth run per rank and step with a candidate among its sequences.
        per_rank = len(runs) // mesh.size
        depth_runs = mesh.size + int(ran.reshape(len(ran), mesh.size, per_rank).any(2).sum())
        mtes, gaps = [], []
        for s, (seed, truth, _) in enumerate(runs):
            summ = r["summaries"][s]
            kf_ids = [0] + [i + 1 for i in np.nonzero(summ[:, 32] > 0.5)[0].tolist()]
            mte = mean_translation_error(truth, r["poses"][s])
            mtes.append(mte)
            gap = float(np.abs(r["poses"][s][:, :3, 3]
                               - single_results[s].poses[:, :3, 3]).max())
            gaps.append(gap)
            print(f"sweep {name} seed={seed}: mte={mte:.6f} keyframes={kf_ids} (run_sequence: "
                  f"{single_results[s].keyframe_ids}) max per-frame translation gap to "
                  f"run_sequence={gap:.6e} m [{card}]", flush=True)
            if name.startswith("(b)") and kf_ids != single_results[s].keyframe_ids:
                raise RuntimeError(f"sweep {name} seed {seed}: keyframes {kf_ids} differ from "
                                   f"run_sequence's {single_results[s].keyframe_ids}")
        med = float(np.median(mtes))
        health = r["health"]
        rate = len(runs) * (num_frames - 1) / r["seconds"]
        steps = num_frames - 1
        print(f"sweep {name}: {len(runs)} sequences x {num_frames} frames on {mesh.size} "
              f"virtual rank(s) of {mesh.devices[0]}: median mte={med:.6f} (gate < 0.15), "
              f"global_ok on {sum(health)}/{len(health)} frames, {rate:.3f} sequence-frames/s "
              f"({r['seconds']:.3f} s, store inserts and the host-read counter included); "
              f"band-kernel launches={band}, full-search launches={full}, ring launches={ring}, "
              f"depth runs={depth_runs}; host reads: init {r['init_reads']}, steps "
              f"{r['step_reads']} ({r['step_reads'] / steps:.2f} per step); largest per-frame "
              f"translation gap to run_sequence {max(gaps):.6e} m [{card}]", flush=True)
        if not med < 0.15:
            raise RuntimeError(f"sweep {name} median mte {med} fails the gate 0.15 ({mtes})")
        if not all(health):
            raise RuntimeError(f"sweep {name}: global_ok False on {health.count(False)} frames")
        if band == 0 or band != depth_runs * _per_call(cfg) or full != 0:
            raise RuntimeError(f"sweep {name}: band launches {band} (depth runs {depth_runs}), "
                               f"full-search launches {full}")
        if not _state_devices_ok(r["final"], mesh):
            raise RuntimeError(f"sweep {name}: a state tensor is not on its rank's device")
    a, b = (results[name] for name in layouts)
    print(f"sweep: host reads per step, one batch {b['step_reads'] / steps:.2f} against "
          f"{a['step_reads'] / steps:.2f} stepping the {len(runs)} sequences in turn "
          f"[{card}]", flush=True)
    if not b["step_reads"] < a["step_reads"]:
        raise RuntimeError(f"sweep: the batch made {b['step_reads']} host reads in its steps, "
                           f"not fewer than the {a['step_reads']} of the steps in turn")
    print(f"sweep: every state tensor on {layouts['(a) one per rank'].devices[0]}", flush=True)
    return a["stores"], b["launches"][0] + _kitti_sweep(card)


KITTI_SWEEP = (22, 13)  # the KITTI benchmark's sequences, frames each


def _kitti_sweep(card) -> int:
    """Phase 10 (c): fast_config on the driving family at 376x1241 for the
    KITTI sweep's 22 sequences (make_driving_scene(s, side_x=20, wall_z=26),
    drive_trajectory(13, step=0.25, seed=s), s = 0..21), batched on
    sequence_mesh(1) and in turn on sequence_mesh(22), in turns batched, in
    turn, batched: sequence-frames/s, peak device memory, median mte (gate <
    0.15 on each run), global_ok frames. Returns the batched runs' B1
    launches."""
    cfg = fast_config()
    S, F = KITTI_SWEEP
    runs = _driving_frames(range(S), F, cfg)
    frames_per_seq = [frames for _, frames in runs.values()]
    layouts = (("batched", 1), ("in turn", S), ("batched", 1))
    band_total = 0
    for name, n in layouts:
        mesh = sequence_mesh(n, CARD)
        health = []
        _reset_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        poses = run_sweep(frames_per_seq, cfg, mesh,
                          progress=lambda i, st, outs, ok: health.append(ok))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**30
        band, full, _ = _counts()
        ok_frames = sum(bool(ok) for ok in health)
        mtes = [mean_translation_error(truth, poses[s]) for s, (truth, _) in
                enumerate(runs.values())]
        med = float(np.median(mtes))
        print(f"kitti sweep {name}: {S} sequences x {F} frames at {cfg.camera.height}x"
              f"{cfg.camera.width} on {n} virtual rank(s): {S * (F - 1) / seconds:.3f} "
              f"sequence-frames/s ({seconds:.3f} s for init and {F - 1} steps), peak device "
              f"memory {peak:.3f} GiB, median mte={med:.6f} (gate < 0.15), max mte="
              f"{max(mtes):.6f}, global_ok on {ok_frames}/{len(health)} frames; band-kernel "
              f"launches={band}, full-search launches={full} [{card}]", flush=True)
        if not med < 0.15:
            raise RuntimeError(f"kitti sweep {name}: median mte {med} fails the gate 0.15")
        if full != 0:
            raise RuntimeError(f"kitti sweep {name}: launched the full-search kernel")
        if name == "batched":
            band_total += band
    return band_total


def _store_ba_phase(card, stores):
    """Phase 11: the ring on the stores' window poses and point blocks, and
    BA on each window, single and sharded over grid_mesh(1, 8). Returns the
    ring's launches on the windows."""
    cfg = fast_config()
    c = cfg.camera
    cam = Pinhole.create(c.fx, c.fy, c.cx, c.cy)
    W = min(5, min(int(st.count) for st in stores))
    print(f"stores: keyframes {[int(st.count) for st in stores]}, window W={W}", flush=True)
    if W < 2:
        raise RuntimeError(f"stores hold too few keyframes for a BA window ({W})")
    slots = [window_slots(st, W) for st in stores]
    mesh = sequence_mesh(len(stores), CARD)

    _reset_counts()  # count this path's launches only
    poses = [st.pose[sl] for st, sl in zip(stores, slots)]
    blocks = [torch.cat([st.xs[sl], st.ys[sl], st.inv_depth[sl], st.intensity[sl]], dim=1)
              for st, sl in zip(stores, slots)]
    got = (ring_exchange.gather_keyframe_poses(poses, mesh, axis="seq"),
           ring_exchange.ring_all_gather(blocks, mesh, axis="seq"))
    torch.cuda.synchronize()
    _, _, ring = _counts()
    for name, outs, shards in (("poses", got[0], poses), ("point blocks", got[1], blocks)):
        plain = ring_exchange.ring_gather_plain(shards)
        ok = all(torch.equal(o, p) for o, p in zip(outs, plain))
        print(f"{'PASS' if ok else 'FAIL'}  ring on the window {name}: {len(shards)} ranks of "
              f"{tuple(shards[0].shape)}, bitwise vs plain", flush=True)
        if not ok:
            raise RuntimeError(f"ring on the window {name} differs from its plain version")
    if ring != 2:
        raise RuntimeError(f"ring launches on the windows: {ring}, expected 2")

    model = grid_mesh(1, 8, CARD)
    for s, (st, sl) in enumerate(zip(stores, slots)):
        problem = BAProblem(images=st.image[sl], xs=st.xs[sl], ys=st.ys[sl],
                            inv_depth=st.inv_depth[sl], intensity=st.intensity[sl],
                            point_valid=st.point_valid[sl], pose=st.pose[sl],
                            kf_valid=st.occupied[sl])
        for fix in (True, False):
            bacfg = BAConfig(iters=4, fix_depths=fix, window=W)
            t0 = time.perf_counter()
            single = ba_solve(problem, cam, bacfg)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            sharded = ba_solve_sharded(problem, cam, model, bacfg)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            dpose = float((sharded.pose - single.pose).abs().max())
            dinv = (sharded.inv_depth - single.inv_depth).abs()
            n1, n2 = int(single.num_residuals), int(sharded.num_residuals)
            c0, c1 = float(single.cost_initial), float(single.cost_final)
            finite = all(bool(torch.isfinite(t).all()) for t in
                         (single.pose, single.inv_depth, sharded.pose, sharded.inv_depth))
            ok = (finite and c1 <= c0
                  and float(sharded.cost_final) <= float(sharded.cost_initial))
            if fix:
                # run_slam's BA (slam.py:112): held to ba_solve as
                # tests/test_distributed.py:81-87 holds the reference.
                ok = ok and dpose <= 2e-4 and float(dinv.max()) <= 1e-4 and n1 == n2
                gates = "gated: dpose <= 2e-4, dinv <= 1e-4, equal residuals"
            else:
                # Free depths: lanes with a near-zero depth Hessian take steps
                # of bd / Hdd that float32 rounding decides, so the single and
                # the sharded solve part (the reference's own two do on such
                # windows; ROADMAP C9). Gated on cost and finiteness only.
                gates = (f"not gated against ba_solve (ROADMAP C9): "
                         f"{int((dinv > 1e-4).sum())} lanes differ by > 1e-4")
            print(f"{'PASS' if ok else 'FAIL'}  BA store {s} W={W} P={problem.xs.shape[1]} "
                  f"fix_depths={fix}: cost {c0:.6f} -> {c1:.6f} (sharded "
                  f"{float(sharded.cost_final):.6f}), residuals {n1}/{n2}, max|dpose|="
                  f"{dpose:.3e}, max|dinv|={float(dinv.max()):.3e} ({gates}); ba_solve "
                  f"{1e3 * (t1 - t0):.3f} ms, ba_solve_sharded (8 ranks) {1e3 * (t2 - t1):.3f} "
                  f"ms [{card}]", flush=True)
            if not ok:
                raise RuntimeError(f"BA on store {s} (fix_depths={fix}) fails its gates")
    return ring


# Phase 12: the loop fixture of tools/verify_loop_closure_tpu.py. The
# reference's endpoint errors there (JAX on a TPU v5e, round 5; PERF.md, "The
# reference's TPU history"): odometry alone 0.019 m, BA + loop closure
# 0.0072 m. They are the reference's figures, not a target.
SLAM_REFERENCE_END_ERR = (0.019, 0.0072)


def _slam_phase(card):
    """Phase 12: run_slam on the loop fixture of ``tools/verify_loop_closure.py``,
    odometry only (BA every 100 keyframes, no loop closure) and with BA every
    2 keyframes and loop closure: the tool's JSON line, its gates and ``OK``,
    then this phase's own gates. Returns B1's launches."""
    cfg = verify_loop_closure.loop_config()
    poses = verify_loop_closure.loop_trajectory()
    truth = np.stack(poses)
    frames = verify_loop_closure.loop_frames(cfg, poses, device="cuda")
    summaries = []
    progress = lambda i, out: summaries.append(out.summary)

    _reset_counts()  # count this path's launches only
    o, m = verify_loop_closure.run_pair(frames, cfg, device="cuda", progress=progress)
    torch.cuda.synchronize()
    band, full, ring = _counts()
    res = {"odometry": o, "slam": m}

    print(json.dumps(verify_loop_closure.report(o, m, poses)), flush=True)

    s = torch.stack(summaries).cpu().numpy()
    # Two inits, and each frame that ran depth (survivors or a failed depth).
    depth_runs = 2 + int(((s[:, 37] > 0) | (s[:, 34] < 0.5)).sum())
    err, ate = {}, {}
    for name, r in res.items():
        err[name] = float(np.linalg.norm(r.poses[-1][:3, 3] - truth[-1][:3, 3]))
        ate[name] = mean_translation_error(truth[: r.num_frames], r.poses)
    rep = m.stage_report
    ms = lambda k: rep[k]["mean_ms"] if k in rep else float("nan")
    print(f"slam: frames={m.num_frames} keyframes={len(m.keyframe_ids)} "
          f"(odometry {len(o.keyframe_ids)}) closures={m.loop_closures} ba_runs={m.ba_runs} "
          f"failed_at={m.failed_at}/{o.failed_at}; endpoint error odometry={err['odometry']:.6f} "
          f"slam={err['slam']:.6f} m; ate (mean translation error) odometry="
          f"{ate['odometry']:.6f} slam={ate['slam']:.6f} m; fps odometry={o.fps:.3f} "
          f"slam={m.fps:.3f}; per verification {ms('verify'):.3f} ms "
          f"({rep.get('verify', {}).get('count', 0)} runs), per closure (a 10-iteration pose-graph "
          f"solve, its write-back and one read of the poses) {ms('close'):.3f} ms, per BA run "
          f"{ms('ba'):.3f} ms [{card}]", flush=True)
    print(f"slam: the reference's endpoint errors on this fixture (JAX on a TPU v5e, round 5, "
          f"not a target): odometry {SLAM_REFERENCE_END_ERR[0]} m, BA + loop closure "
          f"{SLAM_REFERENCE_END_ERR[1]} m; band-kernel launches={band}, full-search "
          f"launches={full}, ring launches={ring}, depth runs={depth_runs}", flush=True)
    verify_loop_closure.check(o, m, poses)
    print("OK", flush=True)
    if m.failed_at is not None or o.failed_at is not None:
        raise RuntimeError(f"slam: depth failed at frame {m.failed_at} / {o.failed_at}")
    if m.loop_closures < 1:
        raise RuntimeError("slam: no loop closure fired")
    if not err["slam"] < 0.2:
        raise RuntimeError(f"slam: endpoint error {err['slam']} fails the gate 0.2")
    if not err["slam"] <= err["odometry"] + 1e-6:
        raise RuntimeError(f"slam: endpoint error {err['slam']} above odometry's "
                           f"{err['odometry']}")
    if band == 0 or band != depth_runs * _per_call(cfg) or full != 0 or ring != 0:
        raise RuntimeError(f"slam: band launches {band} (depth runs {depth_runs}), "
                           f"full-search launches {full}, ring launches {ring}")
    return band


# Phase 13: the command line (odometry_torch/cli.py) on directories written
# here with data/png.py. The driving family of tools/accuracy_sweep.py:75-78,
# seed 4, 25 frames, quantised to 8 bits with one 2-98 percentile stretch for
# the sequence (tests/test_kitti_e2e.py:47-62); a TUM-layout sequence of 10
# frames at 480x640 with tum_rgbd_config's intrinsics and 16-bit depth (z *
# 5000, 0 where unknown or past 65535) in a corridor of make_driving_scene.
CLI_FRAMES, CLI_RESUME_AT, CLI_CHECKPOINT_EVERY = 25, 13, 4
TUM_FRAMES, TUM_STEP = 10, 0.03


def _quantizer(frames):
    allv = np.concatenate([im.ravel() for pair in frames for im in pair])
    lo, hi = float(np.percentile(allv, 2.0)), float(np.percentile(allv, 98.0))
    return lambda im: np.clip(np.round((im - lo) * (255.0 / max(hi - lo, 1e-6))),
                              0, 255).astype(np.uint8)


def _quat(R):
    """(qx, qy, qz, qw) of a rotation matrix (TUM's ground-truth order)."""
    R = np.asarray(R, np.float64)
    w = np.sqrt(max(0.0, 1.0 + R[0, 0] + R[1, 1] + R[2, 2])) / 2.0
    if w > 1e-6:
        return ((R[2, 1] - R[1, 2]) / (4 * w), (R[0, 2] - R[2, 0]) / (4 * w),
                (R[1, 0] - R[0, 1]) / (4 * w), w)
    raise ValueError("rotation too far from identity for this helper")


def _write_kitti_dir(root, cfg, dev):
    """KITTI layout (image_0/1, calib.txt, poses/00.txt) of the driving
    family's seed 4; returns (the left image and depth of frame 0, quantised
    frames, ms per PNG written)."""
    c = cfg.camera
    cam = Pinhole.create(c.fx, c.fy, c.cx, c.cy)
    scene = make_driving_scene(4, side_x=20.0, wall_z=26.0, device=dev)
    poses = drive_trajectory(CLI_FRAMES, step=0.25, seed=4)
    frames, z0 = [], None
    for T in poses:
        left, right, z = render_stereo(scene, cam, c.baseline, T, c.height, c.width)
        frames.append((left.cpu().numpy(), right.cpu().numpy()))
        z0 = z.cpu().numpy() if z0 is None else z0
    q = _quantizer(frames)
    base = os.path.join(root, "dataset", "sequences", "00")
    for d in ("image_0", "image_1"):
        os.makedirs(os.path.join(base, d))
    os.makedirs(os.path.join(root, "poses"))
    t0 = time.perf_counter()
    for i, (left, right) in enumerate(frames):
        png.write_png(os.path.join(base, "image_0", f"{i:06d}.png"), q(left))
        png.write_png(os.path.join(base, "image_1", f"{i:06d}.png"), q(right))
    write_ms = 1e3 * (time.perf_counter() - t0) / (2 * len(frames))
    P0 = np.array([[c.fx, 0, c.cx, 0], [0, c.fy, c.cy, 0], [0, 0, 1, 0]])
    P1 = P0.copy()
    P1[0, 3] = -c.fx * c.baseline
    with open(os.path.join(base, "calib.txt"), "w") as f:
        for name, P in (("P0", P0), ("P1", P1)):
            f.write(name + ": " + " ".join(f"{v:.12e}" for v in P.reshape(-1)) + "\n")
    save_kitti_poses(os.path.join(root, "poses", "00.txt"), poses)
    return (q(frames[0][0]), q(frames[0][1]), z0), write_ms


def _write_tum_dir(root, dev):
    cfg = tum_rgbd_config()
    c = cfg.camera
    cam = Pinhole.create(c.fx, c.fy, c.cx, c.cy)
    scene = make_driving_scene(4, side_x=3.0, wall_z=6.0, device=dev)
    poses = drive_trajectory(TUM_FRAMES, step=TUM_STEP, seed=4)
    for d in ("rgb", "depth"):
        os.makedirs(os.path.join(root, d))
    lines = []
    for i, T in enumerate(poses):
        left, _, z = render_stereo(scene, cam, c.baseline, T, c.height, c.width)
        gray = np.clip(np.round(left.cpu().numpy()), 0, 255).astype(np.uint8)
        zz = z.cpu().numpy() * tum.DEPTH_SCALE
        depth = np.where(np.isfinite(zz) & (zz > 0) & (zz <= 65535), np.round(zz), 0)
        png.write_png(os.path.join(root, "rgb", f"{i}.png"), gray)
        png.write_png(os.path.join(root, "depth", f"{i}.png"), depth.astype(np.uint16))
        qx, qy, qz, qw = (float(v) for v in _quat(T[:3, :3]))
        tx, ty, tz = (float(v) for v in T[:3, 3])
        lines.append(f"{i}.0 {tx!r} {ty!r} {tz!r} {qx!r} {qy!r} {qz!r} {qw!r} "
                     f"{i}.0 rgb/{i}.png {i}.0 depth/{i}.png")
    with open(os.path.join(root, "associated.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")


def _cli(argv, dev, depth_runs=None):
    """cli.main(argv + --device dev) with the launch counts set to 0 just
    before and read just after; returns (its standard output, (B1, B2, B3),
    seconds). `depth_runs`, a one-item list, counts compute_depth calls."""
    out = io.StringIO()
    _reset_counts()
    t0 = time.perf_counter()
    with _depth_calls() as calls, contextlib.redirect_stdout(out):
        rc = cli.main([*argv, "--device", dev])
    if depth_runs is not None:
        depth_runs[0] += calls[0]
    if dev == "cuda":
        torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = _counts()
    if rc != 0:
        raise RuntimeError(f"cli {argv[0]} returned {rc}")
    return out.getvalue(), counts, secs


def _kitti_report(name, text, counts, secs, card):
    report = json.loads(text.strip().splitlines()[-1])
    print(f"cli {name}: {json.dumps(report)}; B1={counts[0]} B2={counts[1]} B3={counts[2]}; "
          f"{secs:.3f} s [{card}]", flush=True)
    return report


def _cli_phase(card, dev="cuda"):
    """Phase 13: the CLI's five subcommands on the card, each gated; returns
    the (B1, B2) launches of its runs."""
    t_phase = time.perf_counter()
    acc, fast = accurate_config(), fast_config()
    per_call = _per_call(acc)
    band = full = 0
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_") as tmp:
        data = os.path.join(tmp, "kitti")
        (left0, right0, z0), write_ms = _write_kitti_dir(data, acc, dev)
        lp, rp = kitti.frame_paths(data, "00", 0)
        t0 = time.perf_counter()
        for i in range(CLI_FRAMES):
            for path in kitti.frame_paths(data, "00", i):
                png.read_gray(path)
        decode_ms = 1e3 * (time.perf_counter() - t0) / (2 * CLI_FRAMES)
        frames = kitti.stereo_frames(data, "00")
        t0 = time.perf_counter()
        n = sum(1 for _ in frames)
        stream_ms = 1e3 * (time.perf_counter() - t0) / (2 * n)
        print(f"cli data: {CLI_FRAMES} stereo pairs at {acc.camera.height}x{acc.camera.width}; "
              f"data/png.py writes {write_ms:.3f} ms and decodes {decode_ms:.3f} ms per PNG "
              f"(host); stereo_frames decoder={frames.decoder}"
              + (f" (native unavailable: {frames.reason})" if frames.reason else "")
              + f", {stream_ms:.3f} ms per PNG through it", flush=True)
        if frames.decoder == "native":
            from odometry_torch.data.native_loader import png_read_gray

            for path in (lp, rp):
                if not np.array_equal(png_read_gray(path), png.read_gray(path)):
                    raise RuntimeError(f"native decoder differs from data/png.py on {path}")
            print("cli data: native decoder bit-equal to data/png.py on frame 0", flush=True)

        # run-kitti, accurate, with the exports.
        out_a = os.path.join(tmp, "out_a")
        argv = ["run-kitti", "--data", data, "--frames", str(CLI_FRAMES), "--config", "accurate"]
        text, counts, secs = _cli([*argv, "--out", out_a, "--dump-vis"], dev)
        rep = _kitti_report("run-kitti accurate", text, counts, secs, card)
        band, full = band + counts[0], full + counts[1]
        if rep["failed_at"] is not None or not rep["mean_translation_error_m"] < 0.15:
            raise RuntimeError(f"run-kitti accurate: {rep}")
        if counts[0] != 0 or counts[1] != CLI_FRAMES * per_call:
            raise RuntimeError(f"run-kitti accurate: launches {counts}, want B2 = {CLI_FRAMES}")
        pred = load_kitti_poses(os.path.join(out_a, "00.txt"))
        gt = kitti.load_poses(data, "00")
        if pred.shape != (CLI_FRAMES, 3, 4) or not np.allclose(pred[0], gt[0], atol=1e-5):
            raise RuntimeError(f"run-kitti accurate: export {pred.shape}, pose 0 off")
        with open(os.path.join(out_a, "vis", "keyframe_ids", "keyframe_id.txt")) as f:
            kf_a = [int(v) for v in f.read().split()]
        for sub in ("gray_img_left", "disparity_left", "mask_left"):
            if len(os.listdir(os.path.join(out_a, "vis", sub))) != rep["keyframes"]:
                raise RuntimeError(f"run-kitti accurate: {sub} has no PNG per keyframe")

        # Checkpoint after CLI_RESUME_AT frames, then resume to the end.
        out_c = os.path.join(tmp, "out_c")
        ck = ["--out", out_c, "--checkpoint-every", str(CLI_CHECKPOINT_EVERY)]
        argv_c = ["run-kitti", "--data", data, "--config", "accurate"]
        text, c1, s1 = _cli([*argv_c, "--frames", str(CLI_RESUME_AT), *ck], dev)
        _kitti_report(f"run-kitti accurate --frames {CLI_RESUME_AT}", text, c1, s1, card)
        text, c2, s2 = _cli([*argv_c, "--frames", str(CLI_FRAMES), *ck, "--resume"], dev)
        rep_r = _kitti_report("run-kitti accurate --resume", text, c2, s2, card)
        band, full = band + c1[0] + c2[0], full + c1[1] + c2[1]
        ckpt = os.path.join(out_c, "00_checkpoint.npz")
        with np.load(ckpt) as f:
            keys = list(f.files)
            kf_r = [int(v) for v in f[next(k for k in keys if k.endswith("|keyframe_ids"))]]
        dpose = float(np.abs(load_kitti_poses(os.path.join(out_c, "00.txt")) - pred).max())
        print(f"cli resume: keyframes {kf_r} (uninterrupted {kf_a}), largest |pose delta| "
              f"{dpose:.3e} over the exported poses; launches B2 {c1[1]} + {c2[1]}; resume "
              f"stage {rep_r['stages'].get('resume')} ms, checkpoint stage "
              f"{rep_r['stages'].get('checkpoint')} ms", flush=True)
        if kf_r != kf_a or not dpose <= 1e-5 or "resume" not in rep_r["stages"]:
            raise RuntimeError(f"resume: keyframes {kf_r} vs {kf_a}, |delta| {dpose}")
        if c1[1] != CLI_RESUME_AT * per_call or c2[1] != (CLI_FRAMES - CLI_RESUME_AT + 1) * per_call:
            raise RuntimeError(f"resume: launches {c1} then {c2}")
        # The same state written from the CPU gives the same keys and arrays.
        state, _ = init(png.read_gray(lp), png.read_gray(rp), acc, device=dev)
        payload = load_pytree(ckpt, runner._checkpoint_template(state))
        cpu = os.path.join(tmp, "cpu.npz")
        save_pytree(cpu, dict(payload, state=interop.state_to_numpy(payload["state"])))
        with np.load(ckpt) as a, np.load(cpu) as b:
            if a.files != b.files or not all(np.array_equal(a[k], b[k]) for k in a.files):
                raise RuntimeError("checkpoint keys or arrays differ from the CPU's")
        print(f"cli checkpoint: {len(keys)} keys, equal to those of the same state written "
              f"from the CPU", flush=True)

        # run-kitti, fast with lazy depth: B1 once per depth run.
        depth_runs = [0]
        text, counts, secs = _cli(["run-kitti", "--data", data, "--frames", str(CLI_FRAMES),
                                   "--config", "fast", "--lazy-depth"], dev, depth_runs)
        rep = _kitti_report("run-kitti fast --lazy-depth", text, counts, secs, card)
        band, full = band + counts[0], full + counts[1]
        print(f"cli run-kitti fast: depth runs {depth_runs[0]}", flush=True)
        if rep["failed_at"] is not None or not rep["mean_translation_error_m"] < 0.15:
            raise RuntimeError(f"run-kitti fast: {rep}")
        if counts[0] == 0 or counts[0] != depth_runs[0] * _per_call(fast) or counts[1] != 0:
            raise RuntimeError(f"run-kitti fast: launches {counts}, depth runs {depth_runs[0]}")

        # eval-disparity on a Middlebury-layout pair of frame 0.
        mid = os.path.join(tmp, "middlebury")
        os.makedirs(mid)
        c = acc.camera
        png.write_png(os.path.join(mid, "view1.png"), left0)
        png.write_png(os.path.join(mid, "view5.png"), right0)
        with np.errstate(divide="ignore", invalid="ignore"):
            disp = np.where(np.isfinite(z0) & (z0 > 0), np.round(c.fx * c.baseline / z0), 0)
        png.write_png(os.path.join(mid, "disp1.png"), np.clip(disp, 0, 255).astype(np.uint8))
        text, counts, secs = _cli(["eval-disparity", "--data", mid, "--fx", repr(c.fx),
                                   "--baseline", repr(c.baseline)], dev)
        band, full = band + counts[0], full + counts[1]
        r = json.loads(text)
        print(f"cli eval-disparity: num_valid={r.get('num_valid')} disparity_mae_px="
              f"{r.get('disparity_mae_px')} depth_mae_m={r.get('depth_mae_m')} "
              f"<=1px={r.get('disparity_cumulative', {}).get('<=1.0px')} "
              f"frame_ok={r['frame_ok']}; B1={counts[0]} B2={counts[1]}; {secs:.3f} s [{card}]",
              flush=True)
        if not r["frame_ok"] or counts != (0, per_call, 0):
            raise RuntimeError(f"eval-disparity: frame_ok {r['frame_ok']}, launches {counts}")

        # run-tum: sensor depth, no SSD search.
        tum_dir = os.path.join(tmp, "tum")
        _write_tum_dir(tum_dir, dev)
        text, counts, secs = _cli(["run-tum", "--data", tum_dir, "--frames", str(TUM_FRAMES)],
                                  dev)
        r = json.loads(text.strip().splitlines()[-1])
        print(f"cli run-tum: {json.dumps(r)}; B1={counts[0]} B2={counts[1]}; {secs:.3f} s "
              f"[{card}]", flush=True)
        if (r["num_frames"] != TUM_FRAMES or r.get("num_gt_matched") != TUM_FRAMES
                or not np.isfinite(r["ate_rmse_m"]) or counts != (0, 0, 0)):
            raise RuntimeError(f"run-tum: {r}, launches {counts}")

        # run-live on a directory holding 5 pairs already.
        watch = os.path.join(tmp, "watch")
        os.makedirs(watch)
        for i in range(5):
            for eye, path in zip(("left", "right"), kitti.frame_paths(data, "00", i)):
                shutil.copy(path, os.path.join(watch, f"{i:06d}_{eye}.png"))
        text, counts, secs = _cli(["run-live", "--watch", watch, "--config", "fast",
                                   "--timeout", "0.5"], dev)
        band, full = band + counts[0], full + counts[1]
        lines = [json.loads(v) for v in text.strip().splitlines()]
        print(f"cli run-live: {len(lines)} lines, first {lines[0] if lines else None}, last "
              f"{lines[-1] if lines else None}; B1={counts[0]} B2={counts[1]}; {secs:.3f} s",
              flush=True)
        if len(lines) != 5 or lines[0].get("init") is not True or counts[0] < 1 or counts[1]:
            raise RuntimeError(f"run-live: {lines}, launches {counts}")

        # The debug checks on the card: a NaN in frame 2's left image.
        frames5 = [(png.read_gray(a), png.read_gray(b))
                   for a, b in (kitti.frame_paths(data, "00", i) for i in range(5))]
        frames5[2][0][10, 10] = np.nan
        try:
            run_sequence(frames5, fast, debug_checks=True, device=dev)
        except DebugCheckError as e:
            msg = str(e)
        else:
            raise RuntimeError("debug checks: a NaN input did not raise")
        if "non-finite LEFT input frame" not in msg or "frame 2" not in msg:
            raise RuntimeError(f"debug checks raised {msg!r}")
        res = run_sequence(frames5, fast, device=dev)
        print(f"cli debug: debug_checks raised {msg!r}; without them the run completed "
              f"{res.num_frames} frames", flush=True)
        if res.num_frames < 3:
            raise RuntimeError(f"debug: the production run stopped at {res.num_frames} frames")
    print(f"cli: phase 13 took {time.perf_counter() - t_phase:.3f} s (B1 {band}, B2 {full} "
          f"launches) [{card}]", flush=True)
    return band, full


# Phase 14: the port's tools. (a) a cut of the accuracy sweep (one seed of
# each preset and family), (b) the weak-scaling report, (c) profile_step.
SWEEP_SEEDS = [3]
SCALING_SIZES = [1, 2, 4, 8]


def _tools_phase(card):
    """Phase 14 (see the module docstring); returns the (B1, B2) launches of
    its three parts, each counted from 0."""
    t_phase = time.perf_counter()
    _reset_counts()
    records = accuracy_sweep.sweep(seeds=SWEEP_SEEDS, device="cuda",
                                   log=lambda line: print(f"sweep: {line} [{card}]", flush=True))
    band, full, _ = _counts()
    for row in accuracy_sweep.summarize(records):
        print(f"sweep: {row['config']}/{row['scene']} median mte {row['median']:.6f} "
              f"({row['n_green']}/{row['n']} under {accuracy_sweep.GATE})", flush=True)
    for r in records:
        name = f"sweep {r['config']}/{r['scene']} seed {r['seed']}"
        if r["error"] is not None or r["failed_at"] is not None:
            raise RuntimeError(f"{name}: depth failed ({r['error'] or r['failed_at']})")
        if r["scene"] != "textured" and not r["mte"] < accuracy_sweep.GATE:
            raise RuntimeError(f"{name}: mte {r['mte']} fails the gate {accuracy_sweep.GATE}")
        per = _per_call(accuracy_sweep.CONFIGS[r["config"]]())
        want = ((r["depth_runs"] * per, 0) if r["config"] == "fast"
                else (0, r["frames"] * per))
        if (r["b1"], r["b2"]) != want or r["b1"] + r["b2"] == 0:
            raise RuntimeError(f"{name}: launches B1 {r['b1']} B2 {r['b2']}, want {want}")
    if (band, full) != (sum(r["b1"] for r in records), sum(r["b2"] for r in records)):
        raise RuntimeError(f"sweep: launch counters {band}/{full} differ from the runs'")

    _reset_counts()
    t0 = time.perf_counter()
    rows = sweep_scaling_report(fast_config(), SCALING_SIZES, device=CARD)
    b, f, _ = _counts()
    band, full = band + b, full + f
    print(format_scaling_table(rows), flush=True)
    print(f"scaling: ops by rank {[r['ops_by_rank'] for r in rows]}; B1 {b}, B2 {f}; "
          f"{time.perf_counter() - t0:.3f} s [{card}]", flush=True)
    for r in rows:
        if not (r["analytic_efficiency_pct"] >= 80.0 and 0 < r["collective_bytes"] < 4096
                and r["steps_per_s"] > 0):
            raise RuntimeError(f"scaling: row {r} fails its gates")

    _reset_counts()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_trace_") as tmp:
        prof = profile_step.profile(accurate_config(), device="cuda", reps=5, trace_dir=tmp,
                                    log=lambda line: print(f"profile accurate: {line}",
                                                           flush=True))
        traces = os.listdir(tmp)
    b, f, _ = _counts()
    band, full = band + b, full + f
    trace = prof["trace"]
    in_trace = sum(op["count"] for op in trace["port_kernels"] if "full_kernel" in op["name"])
    print(f"profile accurate: B2 {in_trace} launches in the trace ({f} counted over the "
          f"tool's run), trace files {traces} [{card}]", flush=True)
    if not (trace["device_busy_ms"] > 0 and trace["device_launches"] > 0 and in_trace > 0
            and f > 0 and b == 0 and traces):
        raise RuntimeError(f"profile accurate: trace {trace}, launches B1 {b} B2 {f}")
    print(f"tools: phase 14 took {time.perf_counter() - t_phase:.3f} s (B1 {band}, B2 {full} "
          f"launches) [{card}]", flush=True)
    return band, full


# Phase 15: the reference's diagnostic tools, each cut to a few runs.
DIAG_SEED = 4


def _finite(*values) -> bool:
    return all(np.isfinite(np.asarray(v, np.float64)).all() for v in values)


def _diag_phase(card, bench_frames):
    """Phase 15: the reference's diagnostic tools through the port on the
    card: ``capacity_knee.measure`` on one row of each sweep (phase 5's seed-4
    frames), ``diag_divergence`` on fast/plane and accurate/driving seed 4,
    ``diag_basin`` on seed 11 with 2 variants, ``diag_depth`` on plane/fast
    and driving/accurate seed 4, ``diag_depth_decomp`` on one seed,
    ``diag_depth_filters`` on 2 variants and ``bisect_fast_robustness`` on 1
    variant x 2 cases. Each is gated on finite output and on its launches, set
    to 0 just before it: B1 once per depth run and B2 never on fast_config, B2
    once per depth run and B1 never on accurate_config. Returns the (B1, B2)
    launches."""
    t_phase = time.perf_counter()
    fast, acc = fast_config(), accurate_config()
    total = [0, 0]
    depth_modules = (odometry_module, diag_depth, diag_depth_decomp, diag_depth_filters)

    def run(name, cfg, kernel, fn):
        _reset_counts()
        t0 = time.perf_counter()
        with _depth_calls(*depth_modules) as calls:
            out = fn()
        torch.cuda.synchronize()
        b1, b2, _ = _counts()
        runs = calls[0] * _per_call(cfg)
        want = (runs, 0) if kernel == "band" else (0, runs)
        print(f"diag {name}: depth runs {calls[0]}, band-kernel launches={b1}, full-search "
              f"launches={b2}; {time.perf_counter() - t0:.3f} s [{card}]", flush=True)
        if runs == 0 or (b1, b2) != want:
            raise RuntimeError(f"diag {name}: launches B1 {b1} B2 {b2}, want {want}")
        total[0] += b1
        total[1] += b2
        return out

    poses, frames = bench_frames
    log = lambda line: print(f"capacity_knee: {line}", flush=True)
    rows = run("capacity_knee", fast, "band", lambda: capacity_knee.knee(
        fast, frames, poses, caps=(2048,), max_residuals=(32768,), device="cuda", log=log))
    for r in rows:
        if not (_finite(r["mte"], r["fps"]) and r["fps"] > 0):
            raise RuntimeError(f"capacity_knee: row {r}")

    for cfg_name, cfg, scene, kernel in (("fast", fast, "plane", "band"),
                                         ("accurate", acc, "driving", "full")):
        d = run(f"diag_divergence {cfg_name}/{scene}", cfg, kernel,
                lambda: diag_divergence.divergence(cfg, scene, DIAG_SEED, device="cuda"))
        for line in diag_divergence.format_run(cfg_name, scene, DIAG_SEED, d):
            print(f"diag_divergence: {line}", flush=True)
        if not d["rows"] or not _finite(d["mte"], [[r["err"], r["motion"], r["err_first"],
                                                     r["err_final"]] for r in d["rows"]]):
            raise RuntimeError(f"diag_divergence {cfg_name}/{scene}: non-finite output")

    rows = run("diag_basin", fast, "band", lambda: diag_basin.basin(
        fast, 11, "plane", diag_basin.VARIANTS[:2], device="cuda"))
    for r in rows:
        print(f"diag_basin: {diag_basin.format_row(r)}", flush=True)
        if not _finite(r["terr"], r["levels"]):
            raise RuntimeError(f"diag_basin: row {r}")

    for cfg_name, cfg, scene, kernel in (("fast", fast, "plane", "band"),
                                         ("accurate", acc, "driving", "full")):
        st = run(f"diag_depth {scene}/{cfg_name}", cfg, kernel,
                 lambda: diag_depth.depth_stats(cfg, scene, DIAG_SEED, device="cuda"))
        print(f"diag_depth: {diag_depth.format_stats(cfg_name, scene, DIAG_SEED, st)}",
              flush=True)
        if not (st["n"] > 0 and _finite(list(st.values()))):
            raise RuntimeError(f"diag_depth {scene}/{cfg_name}: {st}")

    d = run("diag_depth_decomp", fast, "band",
            lambda: diag_depth_decomp.decompose(fast, "plane", 5, device="cuda"))
    for line in diag_depth_decomp.format_decomposition(d):
        print(f"diag_depth_decomp: {line}", flush=True)
    if not _finite(list(d["search"].values()), list(d["refined"].values()), d["bad_by_rows"]):
        raise RuntimeError(f"diag_depth_decomp: {d}")

    variants = [v for v in diag_depth_filters.VARIANTS if v[0] in ("base", "all")]
    rows = run("diag_depth_filters", fast, "band",
               lambda: diag_depth_filters.filters(fast, variants, device="cuda"))
    for r in rows:
        print(f"diag_depth_filters: {diag_depth_filters.format_row(r)}", flush=True)
        if not (min(r["n"]) > 0 and _finite(r["frac1"], r["bias"])):
            raise RuntimeError(f"diag_depth_filters: row {r}")

    log = lambda line: print(f"bisect: {line}", flush=True)
    rows = run("bisect_fast_robustness", fast, "band", lambda: bisect_fast_robustness.bisect(
        fast, bisect_fast_robustness.VARIANTS[:1], device="cuda", log=log))
    for r in rows:
        if r["error"] is not None or not _finite(r["mte"]):
            raise RuntimeError(f"bisect: row {r}")
    print(f"diag: phase 15 took {time.perf_counter() - t_phase:.3f} s (B1 {total[0]}, B2 "
          f"{total[1]} launches) [{card}]", flush=True)
    return tuple(total)


# Phase 16: the reference's measuring tools. The microbench's cut: the lm
# suite at two of its three point counts with both samplers, one point count
# of the gather and sample suites, all of the others.
MICROBENCH_CUT = dict(lm_sizes=(8192, 40960), gather_sizes=(40960,), sample_sizes=(40960,))
# The functions through which the phase's tools make their SSD searches:
# pipeline.odometry's compute_depth (init and step), the microbench's
# compute_depth and disparity_search, trace_step's compute_depth and the
# roofline's disparity_winner_maps. Graph replays launch B1 again without a
# call, and neither the wrappers nor these counts see them.
SEARCH_NAMES = ("compute_depth", "disparity_search", "disparity_winner_maps")


def _positive(*values) -> bool:
    return all(np.isfinite(v) and v > 0 for v in values)


def _measure_phase(card):
    """Phase 16 (see the module docstring); returns the (B1, B2) launches."""
    t_phase = time.perf_counter()
    fast, kitti = fast_config(), kitti_config()
    total = [0, 0]
    modules = (odometry_module, microbench, trace_step, roofline)
    log = lambda line: print(line, flush=True)

    def run(name, cfg, kernel, fn):
        _reset_counts()
        t0 = time.perf_counter()
        with _depth_calls(*modules, names=SEARCH_NAMES) as calls:
            out = fn()
        torch.cuda.synchronize()
        b1, b2, _ = _counts()
        runs = calls[0] * _per_call(cfg)
        want = (runs, 0) if kernel == "band" else (0, runs)
        print(f"measure {name}: searches {calls[0]}, band-kernel launches={b1}, full-search "
              f"launches={b2}; {time.perf_counter() - t0:.3f} s [{card}]", flush=True)
        if (b1, b2) != want:
            raise RuntimeError(f"measure {name}: launches B1 {b1} B2 {b2}, want {want}")
        total[0] += b1
        total[1] += b2
        return out

    rows = run("roofline", fast, "band", lambda: roofline.rows(fast, device="cuda", log=log))
    for r in rows:
        gated = not r["l2_resident"]
        print(f"measure roofline {r['name']}: {r['efficiency_pct']:.1f}% of the bound "
              f"({'gated at 105%' if gated else 'L2-resident, not gated'}) [{card}]", flush=True)
        if not _positive(r["measured_ms"], r["bound_ms"]) or (
                gated and r["efficiency_pct"] > 105.0):
            raise RuntimeError(f"roofline row {r}")

    suites = run("microbench", fast, "band", lambda: microbench.run(
        device="cuda", log=log, **MICROBENCH_CUT))
    for suite, measured in suites.items():
        for r in measured:
            times = [r[k] for k in ("device_ms", "graph_ms", "busy_ms", "wall_ms") if k in r]
            if not (_positive(*times) and r["ops"] > 0):
                raise RuntimeError(f"microbench {suite} row {r}")
    for N in MICROBENCH_CUT["lm_sizes"]:
        for interp in microbench.INTERPS:
            body = microbench.lm_body(microbench.lm_inputs(N), interp, "cuda")
            eager = body()
            graph, replayed = capture(body)
            replayed.zero_()
            graph.replay()
            torch.cuda.synchronize()
            same = torch.equal(replayed, eager)
            print(f"measure lm N={N} interp={interp}: one replay of the captured body gives "
                  f"the eager delta {'bit for bit' if same else 'NOT bit for bit'} "
                  f"(max |diff| {float((replayed - eager).abs().max())})", flush=True)
            if not same:
                raise RuntimeError(f"lm body N={N} {interp}: the graph's delta differs")

    poses, frames = verify_mm.render_frames(fast, device="cuda")
    r = run("verify_mm fast", fast, "band", lambda: verify_mm.track(fast, poses, frames))
    print(f"measure verify_mm [fast/mm] frames={r['frames']} keyframes={r['keyframes']} "
          f"failed_at={r['failed_at']} mte={r['mte']:.6f} fps={r['fps']:.1f} [{card}]",
          flush=True)
    verify_mm.check_fast(r)
    k = verify_mm.KITTI_FRAMES
    r = run("verify_mm kitti", kitti, "full",
            lambda: verify_mm.track(kitti, poses[:k], frames[:k]))
    print(f"measure verify_mm [parity] frames={r['frames']} mte={r['mte']:.6f}", flush=True)
    verify_mm.check_kitti(r)
    sampler = verify_mm.sampler_error()
    pyramid = verify_mm.pyramid_errors(fast.camera.height, fast.camera.width)
    print(f"measure verify_mm: mm vs gather {sampler}, pyr_down vs golden {pyramid}", flush=True)
    verify_mm.check_invariants(sampler, pyramid)
    print("VERIFY OK", flush=True)

    for depth in (False, True):
        with tempfile.TemporaryDirectory() as tmp:
            t = run(f"trace_step{' --depth' if depth else ''}", fast, "band",
                    lambda: trace_step.trace(fast, depth=depth, out_dir=tmp, log=log))
        cats = dict(t["by_category"])
        if not (t["total_ms"] > 0 and t["rows"] and cats.get("ssd", 0) > 0):
            raise RuntimeError(f"trace_step {t['what']}: {t['total_ms']} ms, {cats}")

    t0 = time.perf_counter()
    rc = preflight.main(["--quick"])
    print(f"measure preflight --quick: exit {rc}; {time.perf_counter() - t0:.3f} s (its bench "
          f"runs in a process of its own: its launches are not counted here) [{card}]",
          flush=True)
    if rc != 0:
        raise RuntimeError("preflight --quick is RED")
    print(f"measure: phase 16 took {time.perf_counter() - t_phase:.3f} s (B1 {total[0]}, B2 "
          f"{total[1]} launches) [{card}]", flush=True)
    return tuple(total)


def _multichip_phase(card) -> int:
    """Phase 17: ``tools/multichip.py``'s (a)-(e), (b) on the global mesh and
    (c)/(d) across processes on every visible card (four at most) when there
    are 2 or more; with one card, one line saying that it did not run and
    why. Returns B3's launches on the BA windows of (c) in this process and
    those of the processes of (c)/(d) on their windows and in their sharded
    BA (their ring cases, repeats and timing calls are left out)."""
    count = torch.cuda.device_count()
    if count < 2:
        print(f"multichip: phase 17 did not run: {count} card visible, it needs 2 or more",
              flush=True)
        return 0
    t_phase = time.perf_counter()
    _reset_counts()
    summary = multichip.run([torch.device("cuda", k) for k in range(count)])
    band, full, ring = _counts()
    across = summary["across_processes"]["path_ring_launches"]
    print(f"multichip: phase 17 took {time.perf_counter() - t_phase:.3f} s on {count} cards "
          f"(B1 {band}, B2 {full}, B3 {ring} launches in this process; in the processes of "
          f"(c)/(d) B3 {across} on the windows and BA, "
          f"{summary['across_processes']['ring_launches']} in all) [{card}]", flush=True)
    if band == 0 or full != 0 or summary["ring_launches_c"] == 0 or across == 0:
        raise RuntimeError(f"multichip: launches B1 {band} B2 {full}, B3 on the windows "
                           f"{summary['ring_launches_c']}, across processes {across}")
    return summary["ring_launches_c"] + across


# Phase 18: two processes share the card; each sweeps two driving sequences.
PHASE18_SEEDS = ((0, 1), (2, 3))


def _host_ms(fn, reps):
    """Host time of one of `reps` back-to-back calls after a warm one, the
    card synchronised at the end (as multichip times a gather across
    processes)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / reps


def _multiprocess_phase(card, stores) -> tuple:
    """Phase 18: two processes of tools/multichip.py on the card (a gloo
    group, B3 between them through CUDA IPC), each sweeping its two
    sequences on the global mesh, then B3 and sharded BA across them
    (``multichip.cross_process_job`` on phase 11's stores); held to one
    process's runs. Returns the children's launches of B1 and of B3 on the
    windows and in sharded BA (their ring cases, repeats and timing calls
    are left out)."""
    t_phase = time.perf_counter()
    cfg = fast_config()
    c = cfg.camera
    job = multichip.cross_process_job(stores, cfg, 2)
    t0 = time.perf_counter()
    recs = multichip.per_process([list(s) for s in PHASE18_SEEDS], multichip.NUM_FRAMES,
                                 cards=[0, 0], job=job, timeout=300)
    children_s = time.perf_counter() - t0
    band = sum(int(r["band_launches"]) for r in recs)
    ring = sum(int(r["path_ring_launches"]) for r in recs)
    ring_all = sum(int(r["ring_launches"]) for r in recs)

    # One process: the four sequences on sequence_mesh(2), rank k's batch
    # the sequences of process k.
    seeds = [s for group in PHASE18_SEEDS for s in group]
    runs = multichip.driving_runs(seeds, multichip.NUM_FRAMES, cfg, CARD)
    _reset_counts()
    one = multichip.sweep_run([f for _, f in runs], cfg, sequence_mesh(2, CARD))
    band_one = _counts()[0]
    multichip._gate_run("multiprocess: one process", one, [t for t, _ in runs])
    for k, r in enumerate(recs):
        lanes = slice(2 * k, 2 * k + 2)
        same = (np.array_equal(r["poses"], one["poses"][lanes]) and bool(r["health"].all())
                and [multichip.keyframe_ids(r["promoted"][:, s]) for s in range(2)] ==
                one["keyframes"][lanes])
        rate = 2 * (multichip.NUM_FRAMES - 1) / float(r["seconds"])
        print(f"{'PASS' if same else 'FAIL'}  multiprocess: process {k} of 2 on {CARD}, "
              f"sequences {PHASE18_SEEDS[k]} x {multichip.NUM_FRAMES} frames at {c.height}x"
              f"{c.width} on the global sequence_mesh() (2 ranks): poses and keyframes equal "
              f"one process's rank {k} of sequence_mesh(2), bit for bit; global_ok on "
              f"{int(r['health'].sum())}/{len(r['health'])} frames; {rate:.3f} sequence-frames/s "
              f"({float(r['seconds']):.3f} s), B1 {int(r['sweep_band'])} launches [{card}]",
              flush=True)
        if not same:
            raise RuntimeError(f"multiprocess: process {k}'s lanes differ from one process's")
    sweep_band = sum(int(r["sweep_band"]) for r in recs)
    if sweep_band != band_one or band_one == 0:
        raise RuntimeError(f"multiprocess: B1 launches of the sweeps {sweep_band}, one process "
                           f"{band_one}")

    # B3 and BA across the two processes against one process.
    b = job["ba"]
    problem = BAProblem(*(t.to(CARD) for t in b["problem"]))
    cam = Pinhole.create(*b["camera"])
    ba_one = {fix: ba_solve_sharded(problem, cam, grid_mesh(1, 2, CARD),
                                    BAConfig(iters=b["iters"], fix_depths=fix,
                                             window=problem.xs.shape[0]))
              for fix in (True, False)}
    times = multichip.check_job(recs, job, ba_one, "multiprocess",
                                lambda line: print(line, flush=True))
    for shape in multichip.RING_TIMING:
        label = "x".join(map(str, shape))
        shards = [torch.randn(shape, device=CARD) for _ in range(2)]
        one_ms = device_ms(lambda: ring_exchange.ring_gather(shards), 50)
        one_wall = _host_ms(lambda: ring_exchange.ring_gather(shards), 200)
        nbytes = shards[0].numel() * 4
        bound = ring_bound_ms([s.device for s in shards], nbytes)
        print(f"timing ring across 2 processes of {CARD}, one shard {shape} float32 each: "
              f"{times[f'time_{label}_ms']:.4f} ms per gather (host time of back-to-back "
              f"gathers, the slower process; two host steps each), bound {bound:.4f} ms "
              f"((2 + 4) x {nbytes} B at 3.35 TB/s); the same gather in one process (2 virtual "
              f"ranks, one launch): {one_ms:.4f} ms device time of back-to-back calls, "
              f"{one_wall:.4f} ms host time [{card}]", flush=True)
    print(f"multiprocess: the two host steps of a gather alone on its board "
          f"{times['time_board_ms']:.4f} ms, one gloo barrier {times['time_gloo_barrier_ms']:.4f} "
          f"ms (host time of 200 back-to-back, the slower process) [{card}]", flush=True)
    print(f"multiprocess: phase 18 took {time.perf_counter() - t_phase:.3f} s (the two "
          f"processes {children_s:.3f} s; their B1 {band} launches, B3 {ring} on the windows "
          f"and BA, {ring_all} with the ring cases, repeats and timing) [{card}]",
          flush=True)
    if band == 0 or ring == 0:
        raise RuntimeError(f"multiprocess: the children launched B1 {band}, B3 {ring} times")
    return band, ring


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs a CUDA card",
              file=sys.stderr)
        return 1
    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    t0 = time.perf_counter()
    built = _build.build_all(["disparity_band", "disparity_full", "ring_gather"])
    print(f"build: all kernels in {time.perf_counter() - t0:.3f} s", flush=True)
    for name, (lib_path, seconds) in built.items():
        _build.load(name)
        print(f"build: {lib_path.name} in {seconds:.3f} s", flush=True)
        log = lib_path.with_suffix(".log")
        if log.exists():
            print(log.read_text().strip(), flush=True)

    # Phase 3: every case of odometry_torch/tools/kernel_parity.py.
    parity = kernel_parity.run(log=lambda line: print(line, flush=True))
    failures = [r.label for r in parity if not r.ok]
    if failures:
        raise RuntimeError(f"kernel parity failed: {failures}")
    errs = {k: [r.err for r in parity if r.kernel == k and r.err is not None]
            for k in ("band", "full")}

    timing = {
        "band": _timing("band", "band [12, 192] lr",
                        dict(boundary=4, min_disparity=MIN_D, max_disparity=192, lr=True), card),
        "full": _timing("full", "full search lr",
                        dict(boundary=4, min_disparity=None, max_disparity=None, lr=True), card),
    }
    _timing("full", f"band [12, {W_KITTI}] lr",
            dict(boundary=4, min_disparity=MIN_D, max_disparity=W_KITTI, lr=True), card)
    _tiled_timing(card)
    _batch_timing(card)

    band_launches, e2e_runs, e2e_results = _e2e(card)
    launches = {"band": band_launches, "full": _e2e_full_search(card)}

    timing["ring"], errs["ring"] = _ring_phase(card)
    stores, band10 = _sweep_phase(card, e2e_runs, e2e_results)
    launches["band"] += band10
    launches["ring"] = _store_ba_phase(card, stores)
    launches["band"] += _slam_phase(card)
    band13, full13 = _cli_phase(card)
    launches["band"] += band13
    launches["full"] += full13
    band14, full14 = _tools_phase(card)
    launches["band"] += band14
    launches["full"] += full14
    seed4 = next((poses, frames) for seed, poses, frames in e2e_runs if seed == bench.TIMED_SEED)
    band15, full15 = _diag_phase(card, seed4)
    launches["band"] += band15
    launches["full"] += full15
    band16, full16 = _measure_phase(card)
    launches["band"] += band16
    launches["full"] += full16
    launches["ring"] += _multichip_phase(card)
    band18, ring18 = _multiprocess_phase(card, stores)
    launches["band"] += band18
    launches["ring"] += ring18

    sources = {
        "band": ("disparity_band", "odometry_torch/csrc/disparity_band.cu",
                 "odometry_tpu/kernels/disparity_pallas.py:124"),
        "full": ("disparity_full", "odometry_torch/csrc/disparity_full.cu",
                 "odometry_tpu/kernels/disparity_pallas.py:69"),
        "ring": ("ring_gather", "odometry_torch/csrc/ring_gather.cu",
                 "odometry_tpu/distributed/ring_exchange.py:47"),
    }
    print(json.dumps({"kernels": [{
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": launches[k],
        "max_abs_err": max(errs[k]),
        "library_ms": None,
        **timing[k],
    } for k, (name, source, replaces) in sources.items()]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
