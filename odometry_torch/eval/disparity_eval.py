"""Disparity/depth accuracy harness (the reference test_disparity.cpp role;
port of ``eval/disparity_eval.py``, host numpy).

Computes the same cumulative error histograms the reference prints
(``test_disparity.cpp:160-249``): disparity-error buckets
(<=0.5 ... >20 px) and depth-error buckets (<=0.01 ... >0.5 m), plus means —
as a returned dict instead of stdout, so it can gate CI or sweep configs.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

DISP_BUCKETS = (0.5, 1.0, 2.0, 3.0, 4.0, 5.0, 10.0, 20.0)
DEPTH_BUCKETS = (0.01, 0.05, 0.1, 0.2, 0.3, 0.4, 0.5)


def disparity_histograms(
    pred_disp: np.ndarray,
    gt_disp: np.ndarray,
    valid: np.ndarray,
    *,
    fx: float,
    baseline: float,
) -> Dict:
    """Cumulative error histograms over valid pixels with GT."""
    pred_disp = np.asarray(pred_disp, np.float64)
    gt_disp = np.asarray(gt_disp, np.float64)
    m = np.asarray(valid, bool) & (gt_disp > 0)
    n = int(m.sum())
    if n == 0:
        return {"num_valid": 0}
    derr = np.abs(pred_disp - gt_disp)[m]
    with np.errstate(divide="ignore"):
        depth_pred = fx * baseline / np.maximum(pred_disp[m], 1e-9)
        depth_gt = fx * baseline / gt_disp[m]
    zerr = np.abs(depth_pred - depth_gt)

    disp_hist = {f"<={b}px": float((derr <= b).mean()) for b in DISP_BUCKETS}
    disp_hist[f">{DISP_BUCKETS[-1]}px"] = float((derr > DISP_BUCKETS[-1]).mean())
    depth_hist = {f"<={b}m": float((zerr <= b).mean()) for b in DEPTH_BUCKETS}
    depth_hist[f">{DEPTH_BUCKETS[-1]}m"] = float((zerr > DEPTH_BUCKETS[-1]).mean())
    return {
        "num_valid": n,
        "disparity_mae_px": float(derr.mean()),
        "depth_mae_m": float(zerr.mean()),
        "disparity_cumulative": disp_hist,
        "depth_cumulative": depth_hist,
    }
