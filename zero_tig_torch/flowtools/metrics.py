"""Optical-flow accuracy metrics.

A copy of ``zero_tig_tpu/flowtools/metrics.py`` (:15-46; the ptlflow metrics
the reference sidecar reports, ptlflow_scripts/validate.py:440-450):
end-point error (EPE), Fl-all (EPE > 3 px and > 5% of the ground truth's
magnitude, in percent), px1 (the share within 1 px) and WAUC (KITTI-2015's
weighted area under the inlier curve, thresholds 1..5 px).
"""

from __future__ import annotations

import numpy as np


def flow_metrics(
    pred: np.ndarray, gt: np.ndarray, valid: np.ndarray | None = None
) -> dict[str, float]:
    """pred/gt: (H, W, 2); valid: optional (H, W) mask."""
    epe_map = np.sqrt(np.sum((pred - gt) ** 2, axis=-1))
    mag = np.sqrt(np.sum(gt**2, axis=-1))
    if valid is None:
        valid = np.ones(epe_map.shape, bool)
    else:
        valid = valid.astype(bool)
    epe_v = epe_map[valid]
    mag_v = mag[valid]
    if epe_v.size == 0:
        return {"epe": float("nan"), "fl_all": float("nan"),
                "px1": float("nan"), "wauc": float("nan")}

    fl = (epe_v > 3.0) & (epe_v > 0.05 * np.maximum(mag_v, 1e-9))
    px1 = float(np.mean(epe_v <= 1.0))

    # WAUC: thresholds delta = 1..5 px, weight w = 1 - (delta-1)/5
    num = 0.0
    den = 0.0
    for delta in range(1, 6):
        w = 1.0 - (delta - 1) / 5.0
        num += w * np.mean(epe_v <= delta)
        den += w
    return {
        "epe": float(np.mean(epe_v)),
        "fl_all": float(np.mean(fl) * 100.0),
        "px1": px1,
        "wauc": float(100.0 * num / den),
    }
