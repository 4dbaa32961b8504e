"""Whether what the timed path produced is correct: the plain reference
(``vobench/plain``) follows the program step by step on a sample of its
steps, drawn from the seed, once the window has closed.

The sample comes from the window's last sweep with the most steps: lanes
drawn from the seed, and steps of each lane. For a step i of lane b the
reference

* builds the keyframe from the benchmark's own frames (the lane's frame k,
  k the program's last promotion before i, or 0): depth frontend, pyramids
  and point lists worked out again, nothing taken from the program;
* takes the program's small state after step i - 1 (keyframe pose, warm
  start, poses, counters: the program's own state, which it follows);
* runs the plain step on frame i and compares the program's step i: the
  tracker's pose (``pose_to_kf``), the state carried to step i + 1 (poses,
  counters, flags), the decisions (promotion, lost, depth and tracking
  health) and the depth frontend's survivor count.

The start and the keyframe data that this skips are checked by themselves:
the lane's keyframe inverse depth and validity after ``batched_init`` and at
the end of the sweep against the reference's depth frontend on that frame.

The control (:func:`check` with ``mode="control"``) puts the reference,
computed in bfloat16 (``plain/precision.py``), in the program's place on the
same steps and states.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

NUMBERS = ("trans_gap", "trans_gap_median", "rot_gap", "rot_gap_median", "state_gap",
           "state_gap_median", "decision_flips", "num_valid_gap", "valid_px_diff",
           "inv_depth_gap")


def sample(win, seed: int, cell):
    """(sweep, {lane: [steps]}) of the check: the last sweep with the most
    steps, `limits["check"]["lanes"]` lanes and `["steps_per_lane"]` steps
    each, drawn from the seed."""
    sweep = max(reversed(win.sweeps), key=lambda s: len(s.steps))
    n = len(sweep.steps)
    B = sweep.init["cur_pose"].shape[0]
    spec = cell.limits["check"]
    rng = np.random.default_rng([seed, 2])
    lanes = sorted(int(b) for b in rng.choice(B, min(spec["lanes"], B), replace=False))
    plan = {}
    for b in lanes:
        k = min(spec["steps_per_lane"], n)
        plan[b] = sorted(int(i) for i in rng.choice(np.arange(1, n + 1), k, replace=False))
    return sweep, plan


def _rot_gap(a: torch.Tensor, b: torch.Tensor) -> float:
    """Angle between two rotations (small-angle form, radians)."""
    return float(torch.linalg.norm(a[:3, :3].double() - b[:3, :3].double()) / math.sqrt(2.0))


def _trans_gap(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.linalg.norm(a[:3, 3].double() - b[:3, 3].double()))


def _pose_gap(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.max(torch.abs(a[:3, :4].double() - b[:3, :4].double())))


class Reference:
    """The plain step on one lane at a time, from the benchmark's frames."""

    def __init__(self, cell, left, right, device):
        from vobench import harness
        from vobench.plain import config as plain_config

        self.cfg = harness.build_config(plain_config, cell.config["pipeline"])
        self.left, self.right, self.device = left, right, device
        self._kf = {}

    def keyframe(self, lane: int, k: int, low: bool):
        """The plain state initialised on the lane's frame k (keyframe data)."""
        from vobench.plain.odometry import init
        from vobench.plain.precision import low_precision

        key = (lane, k, low)
        if key not in self._kf:
            with low_precision(low):
                self._kf[key] = init(self.left[k, lane], self.right[k, lane], self.cfg,
                                     device=self.device)[0]
        return self._kf[key]

    def step(self, lane: int, i: int, k: int, small: dict, low: bool):
        """The plain step i of `lane` from keyframe k and the program's small
        state after step i - 1 (one lane's values)."""
        from vobench.plain.odometry import step
        from vobench.plain.precision import low_precision

        state = dataclasses.replace(self.keyframe(lane, k, low), **small)
        with low_precision(low):
            return step(state, self.left[i, lane], self.right[i, lane], self.cfg)


def _lane(small: dict, b: int) -> dict:
    return {k: v[b] for k, v in small.items()}


def _decisions(rec: dict) -> tuple:
    return tuple(bool(rec[k]) for k in ("promoted", "lost", "depth_ok", "track_ok", "healthy")) + (
        int(rec["frame_id"]), int(rec["kf_count"]), int(rec["lost_streak"]))


def _step_view(new_state, out) -> dict:
    """The fields of the program's step record, from the plain step."""
    rec = {k: getattr(new_state, k) for k in ("kf_pose", "pose_init", "cur_pose", "frame_id",
                                              "kf_count", "healthy", "lost_streak")}
    rec.update(pose_to_kf=out.pose_to_kf, promoted=out.promoted, lost=out.lost,
               depth_ok=out.depth_ok, track_ok=out.track_ok, num_valid=out.num_valid_depth)
    return rec


def _depth_readings(valid_a, inv_a, valid_b, inv_b) -> tuple:
    diff = float((valid_a != valid_b).float().mean())
    both = valid_a & valid_b
    gap = float(torch.max(torch.abs(inv_a - inv_b)[both])) if bool(both.any()) else 0.0
    return diff, gap


def check(cell, win, left, right, seed: int, *, device, mode: str = "program",
          detail: dict | None = None) -> dict:
    """The readings of the numbers a cell may compare (:data:`NUMBERS`; the
    pose gaps as the largest and the median over the checked steps). `mode`
    "program" judges the program's outputs; "control" judges the reference
    computed in bfloat16 in the program's place. `detail` receives each
    checked step's gaps."""
    sweep, plan = sample(win, seed, cell)
    ref = Reference(cell, left, right, device)
    low = mode == "control"
    r = dict.fromkeys(NUMBERS, 0.0)
    r["decision_flips"] = 0
    per_step = {"trans_gap": [], "rot_gap": [], "state_gap": []}
    with torch.no_grad():
        for b, steps in plan.items():
            promoted = [bool(s["promoted"][b]) for s in sweep.steps]
            for i in steps:
                k = max([j for j in range(1, i) if promoted[j - 1]], default=0)
                before = sweep.init if i == 1 else sweep.steps[i - 2]
                small = {key: before[key][b] for key in ("kf_pose", "pose_init", "cur_pose",
                                                         "prev_rel", "frame_id", "kf_count",
                                                         "healthy", "lost_streak")}
                want = _step_view(*ref.step(b, i, k, small, False))
                got = (_step_view(*ref.step(b, i, k, small, True)) if low
                       else _lane(sweep.steps[i - 1], b))
                per_step["trans_gap"].append(_trans_gap(got["pose_to_kf"], want["pose_to_kf"]))
                per_step["rot_gap"].append(_rot_gap(got["pose_to_kf"], want["pose_to_kf"]))
                per_step["state_gap"].append(max(_pose_gap(got[key], want[key])
                                                 for key in ("cur_pose", "kf_pose", "pose_init")))
                r["decision_flips"] += int(_decisions(got) != _decisions(want))
                nv_got, nv_want = int(got["num_valid"]), int(want["num_valid"])
                if max(nv_got, nv_want) > 0:
                    r["num_valid_gap"] = max(r["num_valid_gap"],
                                             abs(nv_got - nv_want) / max(nv_got, nv_want))
            # The keyframes this follows: after batched_init, and at the sweep's end.
            k_end = max([j for j in range(1, len(promoted) + 1) if promoted[j - 1]], default=0)
            kfs = [(0, sweep.init_kf)] + ([(k_end, sweep.final_kf)] if k_end else [])
            for k, (valid_p, inv_p) in kfs:
                want = ref.keyframe(b, k, False)
                if low:
                    got = ref.keyframe(b, k, True)
                    valid_g, inv_g = got.kf_valid, got.kf_dpyr[0]
                else:
                    valid_g, inv_g = valid_p[b], inv_p[b]
                diff, gap = _depth_readings(valid_g, inv_g, want.kf_valid, want.kf_dpyr[0])
                r["valid_px_diff"] = max(r["valid_px_diff"], diff)
                r["inv_depth_gap"] = max(r["inv_depth_gap"], gap)
    for k, v in per_step.items():
        r[k] = max(v)
        r[f"{k}_median"] = float(np.median(v))
    r["decision_flips"] = float(r["decision_flips"])
    if detail is not None:
        detail.update(per_step, plan={str(b): s for b, s in plan.items()})
    return r
