"""The SLAM loop: odometry, keyframe map, windowed BA and loop closure,
orchestrated on the host (port of ``pipeline/slam.py``).

Every promoted keyframe is inserted into the ring-buffer ``KeyframeStore``;
every `ba_every` keyframes the newest `window` of them are refined by
windowed photometric BA (motion-only by default: depths come from calibrated
stereo and anchor the gauge); with `loop_closure`, each insertion proposes a
loop on the host, verifies it photometrically on the device and corrects the
ring through the pose graph. After BA or a closure the live tracking state
is re-anchored to the refined newest keyframe, and every emitted pose is
re-composed from its reference keyframe's corrected pose.

Host reads: one packed ``summary`` per frame, as ``run_sequence``; per
insertion the new thumbnail (for the host mirror that makes a proposal read
nothing from the device); per BA run or closure one read of the store's
poses; per verification its ``ok`` flag (and the LM loop's own reads of its
``active`` flag, one per iteration).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Iterable, Optional

import numpy as np
import torch

from odometry_torch.camera.pinhole import Pinhole
from odometry_torch.config import PipelineConfig
from odometry_torch.device import resolve_device
from odometry_torch.mapping.ba import BAConfig, BAProblem, ba_solve
from odometry_torch.mapping.keyframe import (
    KeyframeStore,
    create_store,
    insert_keyframe,
    update_poses,
    window_slots,
)
from odometry_torch.mapping.loop_closure import (
    LoopClosureConfig,
    close_loop,
    propose_loop,
    verify_loop,
)
from odometry_torch.pipeline.odometry import StepOutput, init, step
from odometry_torch.utils.profiling import StageTimer


@dataclasses.dataclass
class SlamResult:
    poses: np.ndarray  # (N, 4, 4)
    keyframe_ids: list
    store: KeyframeStore
    num_frames: int
    failed_at: Optional[int]
    ba_runs: int
    fps: float
    loop_closures: int = 0
    # StageTimer report: "ba", "verify" and "close" spans (each ends in a
    # host read, so it covers the device work).
    stage_report: dict = dataclasses.field(default_factory=dict)


def _ba_window(store: KeyframeStore, cam: Pinhole, bacfg: BAConfig):
    """BA on the newest `bacfg.window` keyframes: (new store, the refined
    newest pose)."""
    slots = window_slots(store, bacfg.window).long()
    problem = BAProblem(images=store.image[slots], xs=store.xs[slots], ys=store.ys[slots],
                        inv_depth=store.inv_depth[slots], intensity=store.intensity[slots],
                        point_valid=store.point_valid[slots], pose=store.pose[slots],
                        kf_valid=store.occupied[slots])
    res = ba_solve(problem, cam, bacfg)
    return update_poses(store, slots, res.pose), res.pose[-1]


def run_slam(frames: Iterable, cfg: PipelineConfig, *, map_capacity: int = 32, window: int = 5,
             ba_every: int = 1, ba_cfg: BAConfig | None = None,
             init_pose: np.ndarray | None = None, loop_closure: bool = False,
             lc_cfg: LoopClosureConfig | None = None,
             progress: Callable[[int, StepOutput], None] | None = None,
             device="cuda") -> SlamResult:
    """Run odometry with map maintenance, in-loop window BA and (with
    `loop_closure`) proposed, verified and corrected loop closures, over an
    iterable of (left, right) float32 image pairs on `device` (the card
    unless the caller asks for the CPU; raises without one). `progress`,
    when given, sees each frame's step output, as in ``run_sequence``."""
    dev = resolve_device(device)
    timer = StageTimer()
    to_dev = lambda a: torch.as_tensor(a, dtype=torch.float32).to(dev)
    it = iter(frames)
    left0, right0 = next(it)
    c = cfg.camera
    cam = Pinhole.create(c.fx, c.fy, c.cx, c.cy)
    bacfg = (ba_cfg or BAConfig(iters=4, fix_depths=True))._replace(window=window)
    lc = lc_cfg or LoopClosureConfig()

    state, ok0 = init(to_dev(left0), to_dev(right0), cfg, init_pose, device=dev)
    if not bool(ok0):
        raise RuntimeError("Init 0-th frame failed! (depth frontend)")

    store = create_store(map_capacity, cfg.tracker.point_capacity, c.height, c.width,
                         device=dev)
    kf0 = state.kf_track[0]
    store = insert_keyframe(store, kf0.pts, kf0.intensity, state.kf_pose, 0,
                            image=state.kf_pyr[0])

    # Host mirror of the store's proposal metadata (slot-aligned), so that a
    # proposal reads nothing from the device. Its poses go stale after a BA
    # run or a closure; refresh() re-syncs them with the one store.pose read
    # those events make anyway.
    th, tw = store.thumb.shape[1:]
    view = dict(
        occupied=np.zeros(map_capacity, bool),
        frame_id=np.full(map_capacity, -1, np.int64),
        pos=np.zeros((map_capacity, 3), np.float32),
        path=np.zeros(map_capacity, np.float32),
        thumb=np.zeros((map_capacity, th, tw), np.float32),
    )
    inserts = 0

    def view_insert(pose_np, fid, path, thumb):
        nonlocal inserts
        slot = inserts % map_capacity
        view["occupied"][slot] = True
        view["frame_id"][slot] = fid
        view["pos"][slot] = pose_np[:3, 3]
        view["path"][slot] = path
        if view["thumb"].size:
            view["thumb"][slot] = thumb.cpu().numpy()
        inserts += 1

    view_insert(state.kf_pose.cpu().numpy(), 0, 0.0, store.thumb[0])

    poses = [state.cur_pose.cpu().numpy()]
    keyframe_ids = [0]
    # Per frame (reference keyframe's frame_id, pose relative to it): the
    # ledger that carries BA and loop-closure corrections into every emitted
    # pose, not only the live state.
    frame_refs = [(0, np.eye(4, dtype=np.float32))]

    def refresh(store):
        """After a map correction: re-sync the mirror's positions and
        re-compose every emitted pose from its keyframe's corrected pose
        (frames whose keyframe left the ring keep their value). One read of
        store.pose; returns it."""
        pose_np = store.pose.cpu().numpy()
        view["pos"] = pose_np[:, :3, 3].copy()
        occ, fid = view["occupied"], view["frame_id"]
        pose_of = {int(f): pose_np[s] for s, f in enumerate(fid) if occ[s]}
        for i, (kf_fid, rel) in enumerate(frame_refs):
            p = pose_of.get(kf_fid)
            if p is not None:
                poses[i] = p @ rel
        return pose_np

    path_len = 0.0
    failed_at = None
    ba_runs = 0
    loop_closures = 0
    kf_since_ba = 0
    t0 = time.perf_counter()
    for frame_id, (left, right) in enumerate(it, start=1):
        state, out = step(state, to_dev(left), to_dev(right), cfg)
        summ = out.summary.cpu().numpy()  # the frame's one host read
        if progress is not None:
            progress(frame_id, out)
        cur_np = summ[:16].reshape(4, 4)
        kf_np = summ[16:32].reshape(4, 4)
        promoted = summ[32] > 0.5
        path_len += float(np.linalg.norm(cur_np[:3, 3] - poses[-1][:3, 3]))
        poses.append(cur_np)
        frame_refs.append((frame_id if promoted else keyframe_ids[-1],
                           np.linalg.inv(kf_np) @ cur_np))
        if not summ[34] > 0.5:  # depth_ok
            failed_at = frame_id
            break
        if not promoted:
            continue
        keyframe_ids.append(frame_id)
        kf = state.kf_track[0]
        new_slot = inserts % map_capacity
        store = insert_keyframe(store, kf.pts, kf.intensity, state.kf_pose, frame_id,
                                state.kf_pyr[0], path_len)
        view_insert(kf_np, frame_id, path_len, store.thumb[new_slot])
        kf_since_ba += 1
        if kf_since_ba >= ba_every and min(inserts, map_capacity) >= window:
            # Re-anchor cur_pose too: at a promotion it equals kf_pose, and a
            # stale value would make the next frame's relative motion absorb
            # the whole correction.
            with timer.stage("ba"):
                store, refined = _ba_window(store, cam, bacfg)
                state = dataclasses.replace(state, kf_pose=refined, cur_pose=refined)
                refresh(store)
            ba_runs += 1
            kf_since_ba = 0
        if loop_closure:
            prop = propose_loop(store, lc, view=view)
            if prop is None:
                continue
            ci, ni = prop
            with timer.stage("verify"):
                ver = verify_loop(store, ci, ni, cam, cfg.tracker, lc)
                accepted = bool(ver.ok)
            if accepted:
                with timer.stage("close"):
                    store = close_loop(store, ci, ni, ver.T_rel, lc)
                    pose_np = refresh(store)
                newest = torch.as_tensor(pose_np[ni], device=dev)
                state = dataclasses.replace(state, kf_pose=newest, cur_pose=newest)
                loop_closures += 1
    total = time.perf_counter() - t0
    n = len(poses)
    return SlamResult(
        poses=np.stack(poses),
        keyframe_ids=keyframe_ids,
        store=store,
        num_frames=n,
        failed_at=failed_at,
        ba_runs=ba_runs,
        fps=(n - 1) / total if n > 1 else 0.0,
        loop_closures=loop_closures,
        stage_report=timer.report(),
    )
