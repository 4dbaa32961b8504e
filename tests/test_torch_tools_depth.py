"""The port's depth diagnostics against the reference's: ``diag_depth``,
``diag_depth_decomp`` and ``diag_depth_filters``.

The reference tools render 376x1241 frames in ``main``, so their quantities
are computed here from the reference's ``compute_depth`` on the frame the
port's tool renders (frame 0 of the sweep trajectory at 96x320) against the
same z. The reference runs op by op (``jax.disable_jit``): compiled, XLA's
fused multiply-adds move a few refined inverse depths across the survival
gates (ROADMAP C2's mechanism; on fast_config's driving seed 4 here the
compiled reference keeps 1551 survivors, the op-by-op reference and the port
1553, with equal inverse depths). Against it the survivors and compared
pixels are held equal and the disparity errors within PX_ATOL.
"""

import dataclasses
import importlib.util
from pathlib import Path

import jax
import numpy as np
import pytest

from odometry_tpu.depth.estimator import compute_depth as j_compute_depth
from odometry_torch.tools import diag_depth, diag_depth_decomp, diag_depth_filters
from tests.torch_tools_reference import port_config, reference_config
from tests.torch_tools_reference import one_torch_thread  # noqa: F401 (autouse)

H, W = 96, 320
PX_ATOL = 1e-5
REPO = Path(__file__).resolve().parents[1]


_FRAMES = {}
_depth_frame = diag_depth.depth_frame


def _frame(cfg, scene, seed, device="cpu"):
    """diag_depth.depth_frame, rendered once per (scene, seed) at H x W."""
    if (scene, seed) not in _FRAMES:
        _FRAMES[(scene, seed)] = _depth_frame(cfg, scene, seed, device=device)
    return _FRAMES[(scene, seed)]


@pytest.fixture(autouse=True)
def _render_once(monkeypatch):
    for module in (diag_depth, diag_depth_decomp, diag_depth_filters):
        monkeypatch.setattr(module, "depth_frame", _frame)


def _reference(cfg_j, scene, seed):
    """The reference tools' quantities (tools/diag_depth.py:54-70) on the
    port tool's frame, the reference run op by op."""
    left, right, z = (a.numpy() for a in _frame(port_config("fast", H, W), scene, seed))
    with jax.disable_jit():
        res = j_compute_depth(left, right, cfg_j.camera, cfg_j.depth)
    fxb = cfg_j.camera.fx * cfg_j.camera.baseline
    m = np.asarray(res.valid) & (z > 0.1) & (z < 100.0)
    d_gt = fxb / z[m]
    return res, m, d_gt, np.asarray(res.inv_depth)[m] * fxb - d_gt


@pytest.mark.parametrize("preset, scene", [("fast", "plane"), ("accurate", "driving")])
def test_depth_stats_match_the_reference(preset, scene):
    got = diag_depth.depth_stats(port_config(preset, H, W), scene, 4, device="cpu")
    res, m, d_gt, derr = _reference(reference_config(preset, H, W), scene, 4)
    assert got["n"] == int(m.sum()) > 0 and got["survivors"] == int(res.num_valid)
    q = np.percentile(np.abs(derr), [50, 90, 99])
    np.testing.assert_allclose([got["p50"], got["p90"], got["p99"], got["bias"]],
                               [*q, np.mean(derr)], rtol=0, atol=PX_ATOL)
    assert got["disp_gt_med"] == pytest.approx(float(np.median(d_gt)), abs=1e-5)
    assert got["frac1"] == pytest.approx(float((np.abs(derr) > 1).mean()), abs=1e-12)
    line = diag_depth.format_stats(preset, scene, 4, got)
    assert line.startswith(f"{preset}/{scene} seed   4: n ") and " bias " in line


def test_decomposition_matches_the_reference():
    got = diag_depth_decomp.decompose(port_config("fast", H, W), "plane", 5, device="cpu")
    res, m, d_gt, e_refined = _reference(reference_config("fast", H, W), "plane", 5)
    e_search = np.asarray(res.disparity)[m] - d_gt
    # tools/diag_depth_decomp.py:44-60.
    for name, e in (("search", e_search), ("refined", e_refined)):
        q = np.percentile(np.abs(e), [50, 90, 95, 99])
        s = got[name]
        np.testing.assert_allclose([s["p50"], s["p90"], s["p95"], s["p99"]], q, rtol=0,
                                   atol=PX_ATOL)
        for key, th in (("frac1", 1), ("frac5", 5)):
            assert s[key] == pytest.approx(float((np.abs(e) > th).mean()), abs=1e-12)
    sg, rb = np.abs(e_search) <= 1, np.abs(e_refined) > 1
    assert got["search_bad"] == float((~sg).mean())  # integer winners: exact
    assert got["search_good_refine_bad"] == pytest.approx(float((sg & rb).mean()),
                                                          abs=1e-12)
    assert len(got["bad_by_rows"]) == 8 and len(got["bad_by_cols"]) == 10
    lines = diag_depth_decomp.format_decomposition(got)
    assert lines[0].startswith("search  : p50 ") and lines[1].startswith("refined : p50 ")
    assert lines[3].startswith("bad-frac by rows: ") and lines[4].startswith("bad-frac by cols: ")


def test_filters_match_the_reference():
    variants = [v for v in diag_depth_filters.VARIANTS if v[0] in ("nounm", "all")]
    seeds = [4]  # where the compiled reference parts (see the module docstring)
    base_t, base_j = port_config("fast", H, W), reference_config("fast", H, W)
    got = diag_depth_filters.filters(base_t, variants, seeds=seeds, device="cpu")
    assert [(r["variant"], r["scene"]) for r in got] == [
        (v, s) for v, _ in variants for s in diag_depth_filters.SCENES]
    for row in got:
        kw = dict(variants)[row["variant"]]
        cfg_j = dataclasses.replace(base_j, depth=dataclasses.replace(base_j.depth, **kw))
        for k, seed in enumerate(seeds):
            res, m, _, derr = _reference(cfg_j, row["scene"], seed)
            assert row["n"][k] == int(m.sum()) and row["survivors"][k] == int(res.num_valid)
            assert row["frac1"][k] == pytest.approx(float((np.abs(derr) > 1).mean()), abs=1e-12)
            assert row["bias"][k] == pytest.approx(float(np.mean(derr)), abs=PX_ATOL)
    assert diag_depth_filters.format_row(got[0]).startswith("nounm      plane   : frac>1px ")
    # The reference tool's variants and seeds (tools/diag_depth_filters.py:30-42).
    spec = importlib.util.spec_from_file_location(
        "diag_depth_filters_ref", REPO / "tools" / "diag_depth_filters.py")
    ref_tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref_tool)
    assert diag_depth_filters.VARIANTS == ref_tool.VARIANTS
    assert list(diag_depth_filters.SEEDS) == ref_tool.SEEDS
