"""Class-agnostic COD metric accumulator (the reference's `calc_cod`).

The port's copy of `camouflaged_vlm_tpu/metrics/cod.py` kept so that the port
imports nothing of the JAX package; the CPU tests hold the two to the same
results.

Equivalent of the reference's `utils.py:143-174`: per-image S-measure,
mean-E-measure-over-curve, weighted F (beta=0.3 here, the sod_metric
default), and MAE over float [0,1] prediction/GT maps at model resolution.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from .sod import mae_score, prepare_pred_gt, s_measure, threshold_curves, weighted_f_measure


class CODMetrics:
    """Accumulates sm / em(curve-mean) / wfm / mae over images."""

    def __init__(self, wfm_beta: float = 0.3):
        self.wfm_beta = wfm_beta
        self.sms = []
        self.em_curves = []
        self.wfms = []
        self.maes = []

    def step(self, pred01: np.ndarray, gt01: np.ndarray) -> None:
        """pred01/gt01: (H, W) float in [0, 1]."""
        pred, gt = prepare_pred_gt(
            (pred01 * 255).astype(np.float64), (gt01 * 255).astype(np.float64)
        )
        self.sms.append(s_measure(pred, gt))
        self.em_curves.append(threshold_curves(pred, gt).em_curve)
        self.wfms.append(weighted_f_measure(pred, gt, self.wfm_beta))
        self.maes.append(mae_score(pred, gt))

    def results(self) -> Tuple[float, float, float, float]:
        """(sm, em, wfm, mae) — em is the mean over images and thresholds."""
        return (
            float(np.mean(self.sms)),
            float(np.mean(np.stack(self.em_curves))),
            float(np.mean(self.wfms)),
            float(np.mean(self.maes)),
        )


def calc_cod_batch(pred: np.ndarray, gt: np.ndarray) -> Tuple[float, float, float, float]:
    """pred/gt: (B, H, W) float [0,1]. Returns batch-mean (sm, em, wfm, mae)."""
    m = CODMetrics()
    for i in range(pred.shape[0]):
        m.step(pred[i], gt[i])
    return m.results()
