"""One run of one cell: set-up, the measured window, the metrics, the check.

The program under test is ``odometry_torch``'s batched sweep:
``distributed.sweep.batched_init`` and ``batched_step`` over every lane of the
cell as one batch on ``sequence_mesh(None, device)``. Sweeps of the
configuration's ``sequence_frames`` frames run back to back on the same
frames, each from a ``batched_init``, as the KITTI driver starts each
sequence. After every step the harness reads the step's packed summary
(``StepOutput.summary``: poses, keyframe pose and flags) to the host, as a
consumer of each frame's pose does.

Everything that belongs to a cell is data found by name: the configuration
(``configs/<config>.json``), the traffic (``traffic/<traffic>.json``), the
limits of its check (``limits/<cell>.json``) and one reader per metric
(``metrics/<metric>.py``).
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "odometry_tpu")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict  # configs/<config>.json
    traffic: dict  # traffic/<traffic>.json
    limits: dict  # limits/<cell>.json
    end_to_end: list  # BENCHMARK.json entries this cell reports
    per_layer: list

    @property
    def lanes(self) -> list:
        lo, hi = self.traffic["lane_seeds"]
        return list(range(lo, hi))

    @property
    def frames(self) -> int:
        return int(self.config["sequence_frames"])


def manifest(root: Path = ROOT) -> dict:
    path = root / "BENCHMARK.json"
    if not path.exists():
        raise FileNotFoundError(f"{path} not found")
    return json.loads(path.read_text())


def _reports(entry: dict, cell: str, e2e_names: set) -> bool:
    if "workloads" in entry:
        return cell in entry["workloads"]
    return "moves" not in entry or entry["moves"] in e2e_names


def load_cell(name: str, man: dict | None = None, root: Path = ROOT) -> Cell:
    """The cell `name` of the manifest with its files, found by name."""
    man = manifest(root) if man is None else man
    work = {w["name"]: w for w in man["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = work[name]
    cfg = {c["name"]: c for c in man["configs"]}[w["config"]]
    e2e = [m for m in man["end_to_end"] if _reports(m, name, set())]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in man["per_layer"] if _reports(m, name, names)]
    here = root / "vobench"
    return Cell(
        name=name, chips=int(w["chips"]), config_name=w["config"],
        config=json.loads((root / cfg["file"]).read_text()),
        traffic=json.loads((here / "traffic" / f"{w['traffic']}.json").read_text()),
        limits=json.loads((here / "limits" / f"{name}.json").read_text()),
        end_to_end=e2e, per_layer=per_layer,
    )


def build_config(module, d: dict):
    """``module.PipelineConfig`` (the port's or the plain copy's) from a
    configuration file's ``pipeline`` section."""

    def make(cls, values: dict):
        kw = {}
        for f in dataclasses.fields(cls):
            if f.name not in values:
                raise KeyError(f"{cls.__name__}.{f.name} missing from the configuration")
            v = values[f.name]
            default = f.default if f.default is not dataclasses.MISSING else None
            if dataclasses.is_dataclass(default):
                v = make(type(default), v)
            elif isinstance(v, list):
                v = tuple(v)
            kw[f.name] = v
        extra = set(values) - {f.name for f in dataclasses.fields(cls)}
        if extra:
            raise KeyError(f"{cls.__name__}: unknown keys {sorted(extra)}")
        return cls(**kw)

    return make(module.PipelineConfig, d)


def load_reader(metric: str, root: Path = ROOT):
    """``read(run)`` of ``metrics/<metric>.py``."""
    path = root / "vobench" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"vobench_metric_{metric.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


# ----------------------------------------------------------------------------- frames


def render_frames(cell: Cell, lane_seeds, device) -> tuple[torch.Tensor, torch.Tensor]:
    """Every lane's stereo pairs on `device`: (left, right), each
    (frames, lanes, H, W) float32, lane b from scene and trajectory seed
    ``lane_seeds[b]``."""
    from vobench.plain.pinhole import Pinhole
    from vobench.render import drive_trajectory, make_driving_scene, stereo_sequence

    cam_cfg = cell.config["pipeline"]["camera"]
    H, W = cam_cfg["height"], cam_cfg["width"]
    cam = Pinhole.create(cam_cfg["fx"], cam_cfg["fy"], cam_cfg["cx"], cam_cfg["cy"])
    tr = cell.traffic
    if tr["scene"] != "driving":
        raise ValueError(f"unknown scene family {tr['scene']!r}")
    F, B = cell.frames, len(lane_seeds)
    left = torch.empty((F, B, H, W), dtype=torch.float32, device=device)
    right = torch.empty_like(left)
    with torch.no_grad():
        for b, s in enumerate(lane_seeds):
            scene = make_driving_scene(int(s), **tr["scene_args"], device=device)
            poses = drive_trajectory(F, **tr["trajectory"], seed=int(s))
            left[:, b], right[:, b] = stereo_sequence(scene, cam, cam_cfg["baseline"], poses,
                                                      H, W)
    return left, right


def lane_order(cell: Cell, seed: int) -> list:
    """The cell's lane seeds in the order `seed` draws: every seed runs the
    same lanes, in another order."""
    lanes = np.asarray(cell.lanes)
    return [int(s) for s in lanes[np.random.default_rng([seed, 1]).permutation(len(lanes))]]


# ----------------------------------------------------------------------------- window

_SMALL = ("kf_pose", "pose_init", "cur_pose", "prev_rel", "frame_id", "kf_count", "healthy",
          "lost_streak")


def _cat(ts):
    return ts[0] if len(ts) == 1 else torch.cat([t.to(ts[0].device) for t in ts])


def _small(states) -> dict:
    """References to the small fields of a per-rank state list, lanes
    concatenated (no copy on one rank)."""
    return {k: _cat([getattr(s, k) for s in states]) for k in _SMALL}


@dataclasses.dataclass
class Sweep:
    """What one sweep of the window left for the check: references to the
    program's tensors, read after the window closes."""

    init: dict  # small state after batched_init
    init_kf: tuple  # (kf_valid, kf inverse depth) after batched_init
    steps: list = dataclasses.field(default_factory=list)  # per step: small state + outputs
    final_kf: tuple | None = None


@dataclasses.dataclass
class Window:
    steps: list  # per step: {"t0", "t1", "lanes", "kind"}
    window_s: float
    frames_done: int
    launches: dict  # SSD kernel launches in the window, by kernel
    lm_iters: list  # per stepped step: sum over levels of the most iterations among lanes
    sweeps: list  # the last two Sweep records
    depth_failed: int
    trace: object = None  # trace.TraceSummary of the traced steps (--trace 1)


def _launch_counts() -> dict:
    from odometry_torch.kernels import disparity_band, disparity_full

    return {"band": disparity_band.LAUNCHES, "full": disparity_full.LAUNCHES}


def setup_program(cell: Cell, device: str):
    """(port config, mesh) of the cell."""
    from odometry_torch import config as port_config
    from odometry_torch.distributed.mesh import sequence_mesh

    cfg = build_config(port_config, cell.config["pipeline"])
    return cfg, sequence_mesh(None, device)


def _host_read(outs_or_states, stepped: bool):
    if stepped:
        return [o.summary.cpu() for o in outs_or_states]
    return [s.cur_pose.cpu() for s in outs_or_states]


def warm_up(left, right, cfg, mesh, steps: int, sweep_mod) -> None:
    """Run an init and `steps` steps on the cell's own frames (every shape the
    window uses: the whole batch and the sub-batches lazy depth takes)."""
    states = sweep_mod.batched_init(left[0], right[0], cfg, mesh)
    _host_read(states, False)
    for i in range(1, 1 + steps):
        states, outs, _ = sweep_mod.batched_step(states, left[i], right[i], cfg, mesh)
        _host_read(outs, True)
    del states, outs


def run_window(left, right, cfg, mesh, seconds: float, *, trace_steps: int = 0,
               step_fn=None) -> Window:
    """Sweeps back to back for `seconds` (ending at the first step that
    completes past it). With `trace_steps`, the profiler records that many
    steps after the first init. `step_fn` replaces ``batched_step`` (tests
    break the timed path with it)."""
    from odometry_torch.distributed import sweep as sweep_mod

    from vobench import trace as trace_mod

    step = sweep_mod.batched_step if step_fn is None else step_fn
    F, B = left.shape[0], left.shape[1]
    timeline, lm_refs, sweeps = [], [], []
    frames_done = 0
    fail_refs = []
    launches0 = _launch_counts()
    tracer = None
    t_start = time.perf_counter()
    done = False
    while not done:
        t0 = time.perf_counter()
        states = sweep_mod.batched_init(left[0], right[0], cfg, mesh)
        _host_read(states, False)
        t1 = time.perf_counter()
        timeline.append({"t0": t0, "t1": t1, "lanes": B, "kind": "init"})
        frames_done += B
        sw = Sweep(init=_small(states),
                   init_kf=(_cat([s.kf_valid for s in states]),
                            _cat([s.kf_dpyr[0] for s in states])))
        sweeps = (sweeps + [sw])[-2:]
        fail_refs.append(_cat([s.healthy for s in states]))
        for i in range(1, F):
            if trace_steps and tracer is None:
                tracer = trace_mod.Tracer()
                tracer.start()
            t0 = time.perf_counter()
            states, outs, _ = step(states, left[i], right[i], cfg, mesh)
            summary = _host_read(outs, True)
            t1 = time.perf_counter()
            timeline.append({"t0": t0, "t1": t1, "lanes": B, "kind": "step"})
            frames_done += B
            rec = _small(states)
            rec.update(pose_to_kf=_cat([o.pose_to_kf for o in outs]),
                       promoted=_cat([o.promoted for o in outs]),
                       lost=_cat([o.lost for o in outs]),
                       depth_ok=_cat([o.depth_ok for o in outs]),
                       track_ok=_cat([o.track_ok for o in outs]),
                       num_valid=_cat([o.num_valid_depth for o in outs]),
                       summary=np.concatenate([s.numpy() for s in summary]))
            sw.steps.append(rec)
            sw.final_kf = (_cat([s.kf_valid for s in states]),
                           _cat([s.kf_dpyr[0] for s in states]))
            lm_refs.append([_cat([o.track_stats[k].iters for o in outs])
                            for k in range(len(outs[0].track_stats))])
            fail_refs.append(rec["depth_ok"])
            if tracer is not None and tracer.active:
                tracer.step_done()
                if tracer.steps >= trace_steps:
                    tracer.stop()
            if t1 - t_start >= seconds:
                done = True
                break
        else:
            if time.perf_counter() - t_start >= seconds:
                done = True
    window_s = timeline[-1]["t1"] - t_start
    launches1 = _launch_counts()
    del states, outs
    lm = [float(sum(int(t.max()) for t in levels)) for levels in lm_refs]
    failed = int(sum(int((~f).sum()) for f in fail_refs))
    summary = None
    if tracer is not None:
        if tracer.active:
            tracer.stop()
        summary = tracer.summary()
    return Window(steps=timeline, window_s=window_s, frames_done=frames_done,
                  launches={k: launches1[k] - launches0[k] for k in launches0},
                  lm_iters=lm, sweeps=sweeps, depth_failed=failed, trace=summary)


# ----------------------------------------------------------------------------- result


def forbidden_modules() -> list:
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


@dataclasses.dataclass
class Run:
    """What a metric reader reads."""

    cell: Cell
    window: Window
    setup_s: float
    lanes: int

    @property
    def steps(self) -> list:
        return self.window.steps

    @property
    def trace(self):
        return self.window.trace


def read_metrics(run: Run, entries: list) -> dict:
    out = {}
    for m in entries:
        value = load_reader(m["name"])(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def device_info(device: str, chips: int, trace) -> dict:
    dev = torch.device(device)
    info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu",
            "count": chips,
            "memory_peak_bytes": (max(torch.cuda.max_memory_allocated(k) for k in range(chips))
                                  if dev.type == "cuda" else 0)}
    if trace is not None:
        info["busy_s"] = trace.busy_s
        info["window_s"] = trace.window_s
    return info


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, *, device: str = "cuda",
             t_process: float | None = None, step_fn=None, log=None) -> dict:
    """One run of `cell`: set-up, window, metrics, check. Returns the result
    line as a dict (keys in the order they are printed)."""
    from odometry_torch.distributed import sweep as sweep_mod

    from vobench import check as check_mod

    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    t_setup0 = time.perf_counter() if t_process is None else t_process
    if device == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.cuda.reset_peak_memory_stats()
    order = lane_order(cell, seed)
    t0 = time.perf_counter()
    left, right = render_frames(cell, order, device)
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    cfg, mesh = setup_program(cell, device)
    warm_up(left, right, cfg, mesh, int(cell.traffic.get("warmup_steps", 2)), sweep_mod)
    if device == "cuda":
        torch.cuda.synchronize()
    t2 = time.perf_counter()
    setup_s = t2 - t_setup0
    log(f"vobench: {cell.name} seed {seed}: set-up {setup_s:.3f} s (imports {t0 - t_setup0:.3f}, "
        f"frames {t1 - t0:.3f}, warm-up {t2 - t1:.3f}), lanes {len(order)}")
    win = run_window(left, right, cfg, mesh, seconds,
                     trace_steps=int(cell.traffic.get("trace_steps", 8)) if trace else 0,
                     step_fn=step_fn)
    log(f"vobench: window {win.window_s:.3f} s, {len(win.steps)} steps, "
        f"{win.frames_done} lane-frames")
    info = device_info(device, cell.chips, win.trace)
    bad = forbidden_modules()
    if bad:
        raise SystemExit(f"vobench: refused: modules loaded: {', '.join(bad)}")
    run = Run(cell=cell, window=win, setup_s=setup_s, lanes=len(order))
    metrics = read_metrics(run, cell.per_layer if trace else cell.end_to_end)
    del mesh
    if device == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    readings = check_mod.check(cell, win, left, right, seed, device=device)
    log(f"vobench: check {time.perf_counter() - t_check:.3f} s")
    compared = {k: {"value": readings[k], "limit": limit}
                for k, limit in cell.limits["limits"].items()}
    correct = all(c["value"] <= c["limit"] for c in compared.values())
    log("vobench: readings " + json.dumps(readings))
    for k, c in compared.items():
        log(f"{k} {c['value']!r} limit {c['limit']!r}")
    result = {"correct": correct,
              "attempted": win.frames_done,
              "failed": win.depth_failed,
              "metrics": metrics,
              "device": info}
    if trace and win.trace is not None:
        result["breakdown"] = win.trace.breakdown()
    result["compared"] = compared
    return result
