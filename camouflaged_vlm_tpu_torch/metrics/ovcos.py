"""Class-aware OVCOS metrics.

The port's copy of `camouflaged_vlm_tpu/metrics/ovcos.py` kept so that the port
imports nothing of the JAX package; the CPU tests hold the two to the same
results.

Equivalent of the reference's `recorder/ovcos_metricer.py`: the standard SOD
metrics where a wrong predicted class zeroes the image's score (or maxes it
to 1 for MAE) — `ovcos_metricer.py:19-20,38-39,61-62,85-87,112-114,138-140`.
Per-image work (one histogram sweep + wFm's distance transform) can run in a
thread pool — it is the eval-throughput ceiling once the model is fast.

Conventions carried over exactly: Fm beta=0.3, wFm beta=1.0 (note: differs
from the class-agnostic COD path's 0.3), Sm alpha=0.5; final aggregation
reports sm/wfm/mae means and adp/max/avg for fm/em/iou
(`ovcos_metricer.py:276-297`).
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Optional, Sequence

import numpy as np

from .sod import (
    mae_score,
    prepare_pred_gt,
    s_measure,
    threshold_curves,
    weighted_f_measure,
)


def _image_scores(
    pred: np.ndarray, gt: np.ndarray, class_match: bool
) -> Dict[str, np.ndarray]:
    pred, gt = prepare_pred_gt(pred, gt)
    if not class_match:
        return {
            "sm": 0.0,
            "wfm": 0.0,
            "mae": 1.0,
            "fm_adp": 0.0,
            "em_adp": 0.0,
            "iou_adp": 0.0,
            "fm_curve": np.zeros(256),
            "em_curve": np.zeros(256),
            "iou_curve": np.zeros(256),
        }
    stats = threshold_curves(pred, gt, fm_beta=0.3)
    return {
        "sm": s_measure(pred, gt),
        "wfm": weighted_f_measure(pred, gt, beta=1.0),
        "mae": mae_score(pred, gt),
        "fm_adp": stats.fm_adp,
        "em_adp": stats.em_adp,
        "iou_adp": stats.iou_adp,
        "fm_curve": stats.fm_curve,
        "em_curve": stats.em_curve,
        "iou_curve": stats.iou_curve,
    }


class OVCOSMetricer:
    """Accumulating class-aware metricer (predictions/GT as uint8 maps)."""

    def __init__(self, class_names: Sequence[str], num_workers: int = 8):
        self.class_names = list(class_names)
        self._records = []
        self._pool = ThreadPoolExecutor(max_workers=num_workers) if num_workers else None

    def step(
        self,
        pre: np.ndarray,
        gt: np.ndarray,
        pre_cls: str,
        gt_cls: str,
        gt_path: Optional[str] = None,
    ) -> None:
        assert pre.shape == gt.shape, (pre.shape, gt.shape, gt_path)
        assert pre.dtype == gt.dtype == np.uint8, (pre.dtype, gt.dtype, gt_path)
        match = pre_cls == gt_cls
        if self._pool is not None:
            self._records.append(
                self._pool.submit(_image_scores, pre.copy(), gt.copy(), match)
            )
        else:
            self._records.append(_image_scores(pre, gt, match))

    def _gathered(self):
        recs = [
            r.result() if hasattr(r, "result") else r for r in self._records
        ]
        # all futures drained — release the worker threads (a metricer per
        # eval round would otherwise leak 8 threads per round)
        self._records = recs
        if self._pool is not None:
            self._pool.shutdown(wait=False)
            self._pool = None
        return recs

    def show(self, num_bits: int = 3) -> Dict[str, float]:
        recs = self._gathered()
        assert recs, "no images stepped"
        out: Dict[str, float] = {}
        for key in ("sm", "wfm", "mae"):
            out[key] = float(np.mean([r[key] for r in recs]))
        for key in ("fm", "em", "iou"):
            adp = float(np.mean([r[f"{key}_adp"] for r in recs]))
            curve = np.mean(np.stack([r[f"{key}_curve"] for r in recs]), axis=0)
            out[f"adp{key}"] = adp
            out[f"max{key}"] = float(curve.max())
            out[f"avg{key}"] = float(curve.mean())
        if num_bits is not None:
            out = {k: round(v, num_bits) for k, v in out.items()}
        return out


def calc_ovcamo(
    pre: np.ndarray, gt: np.ndarray, pre_cls: str, gt_cls: str, gt_path=None
) -> Dict[str, float]:
    """Single-image convenience wrapper (reference `calc_ovcamo`, :227-254)."""
    m = OVCOSMetricer(class_names=[gt_cls], num_workers=0)
    m.step(pre, gt, pre_cls, gt_cls, gt_path)
    return m.show(num_bits=None)
