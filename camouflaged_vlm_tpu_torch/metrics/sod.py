"""Salient/camouflaged-object segmentation metrics (numpy, per image).

The port's copy of `camouflaged_vlm_tpu/metrics/sod.py` kept so that the port
imports nothing of the JAX package; the CPU tests hold the two to the same
results.

Functional re-implementations of the standard SOD metric suite with the same
numerical conventions as the reference's vendored PySODMetrics copies
(the reference's `recorder/sod_metric.py`, semantics also used via
`py_sod_metrics` in the reference's `recorder/ovcos_metricer.py`):

  * inputs are uint8 (0..255) prediction/GT maps;
  * GT binarised at >128, prediction /255 then min-max normalised;
  * threshold curves computed over 256 thresholds via cumulative histograms
    (one shared histogram pass feeds F-measure, E-measure and IoU here —
    the reference recomputes it three times);
  * epsilon = np.spacing(1), float64 accumulation.

Citations: S-measure (Fan et al., ICCV'17), E-measure (Fan et al.,
IJCAI'18), weighted F (Margolin et al., CVPR'14), F-measure (Achanta et
al., CVPR'09), MAE (Perazzi et al., CVPR'12).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
from scipy.ndimage import convolve, distance_transform_edt

EPS = np.spacing(1)


def prepare_pred_gt(pred: np.ndarray, gt: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """uint8 maps -> (pred float64 minmax-normalised in [0,1], gt bool)."""
    gt = gt > 128
    pred = pred.astype(np.float64) / 255.0
    lo, hi = pred.min(), pred.max()
    if hi != lo:
        pred = (pred - lo) / (hi - lo)
    return pred, gt


def adaptive_threshold(pred: np.ndarray, max_value: float = 1.0) -> float:
    return min(2.0 * float(pred.mean()), max_value)


def mae_score(pred: np.ndarray, gt: np.ndarray) -> float:
    return float(np.mean(np.abs(pred - gt)))


# ---------------------------------------------------------------- S-measure

def _s_object_term(vals: np.ndarray) -> float:
    """2x̄ / (x̄² + 1 + σx) over the masked values."""
    if vals.size == 0:
        return 0.0
    x = vals.mean()
    sigma = vals.std(ddof=1) if vals.size > 1 else 0.0
    return float(2.0 * x / (x * x + 1.0 + sigma + EPS))


def _ssim_block(pred: np.ndarray, gt: np.ndarray) -> float:
    n = pred.size
    if n <= 1:
        # documented divergence: the vendored reference (sod_metric.py)
        # divides by N-1 == 0 here and propagates nan for 1-pixel region
        # blocks (GT centroid on the image border); we score the degenerate
        # block as a perfect match instead
        return 1.0
    x, y = pred.mean(), gt.mean()
    sx = ((pred - x) ** 2).sum() / (n - 1)
    sy = ((gt - y) ** 2).sum() / (n - 1)
    sxy = ((pred - x) * (gt - y)).sum() / (n - 1)
    a = 4.0 * x * y * sxy
    b = (x * x + y * y) * (sx + sy)
    if a != 0:
        return float(a / (b + EPS))
    return 1.0 if b == 0 else 0.0


def s_measure(pred: np.ndarray, gt: np.ndarray, alpha: float = 0.5) -> float:
    """Structure measure on prepared (float pred, bool gt) maps."""
    y = gt.mean()
    if y == 0:
        return float(1.0 - pred.mean())
    if y == 1:
        return float(pred.mean())

    # object term
    gtf = gt.astype(np.float64)
    s_obj = y * _s_object_term((pred * gtf)[gt]) + (1.0 - y) * _s_object_term(
        ((1.0 - pred) * (1.0 - gtf))[~gt]
    )

    # region term: split at the (matlab 1-based) GT centroid. gt.any() is
    # guaranteed here — the y == 0 case early-returned above.
    h, w = gt.shape
    cy, cx = np.argwhere(gt).mean(axis=0).round()
    cx, cy = int(cx) + 1, int(cy) + 1
    area = h * w
    weights = (
        cx * cy / area,
        cy * (w - cx) / area,
        (h - cy) * cx / area,
    )
    weights = weights + (1.0 - sum(weights),)
    blocks = (
        (pred[:cy, :cx], gtf[:cy, :cx]),
        (pred[:cy, cx:], gtf[:cy, cx:]),
        (pred[cy:, :cx], gtf[cy:, :cx]),
        (pred[cy:, cx:], gtf[cy:, cx:]),
    )
    s_reg = sum(wt * _ssim_block(p, g) for wt, (p, g) in zip(weights, blocks))
    return float(max(0.0, alpha * s_obj + (1.0 - alpha) * s_reg))


# --------------------------------------------------- weighted F-measure

def _matlab_gauss2d(shape=(7, 7), sigma=5.0) -> np.ndarray:
    m, n = [(s - 1) / 2 for s in shape]
    y, x = np.ogrid[-m : m + 1, -n : n + 1]
    h = np.exp(-(x * x + y * y) / (2.0 * sigma * sigma))
    h[h < np.finfo(h.dtype).eps * h.max()] = 0
    s = h.sum()
    return h / s if s != 0 else h


def weighted_f_measure(pred: np.ndarray, gt: np.ndarray, beta: float = 0.3) -> float:
    """Margolin et al. weighted F on prepared maps. Returns 0 for empty GT."""
    if not gt.any():
        return 0.0
    dst, idx = distance_transform_edt(~gt, return_indices=True)
    err = np.abs(pred - gt.astype(np.float64))
    err_t = err.copy()
    bg = ~gt
    err_t[bg] = err_t[idx[0][bg], idx[1][bg]]
    ea = convolve(err_t, _matlab_gauss2d(), mode="constant", cval=0)
    min_e_ea = np.where(gt & (ea < err), ea, err)
    importance = np.where(bg, 2.0 - np.exp(np.log(0.5) / 5.0 * dst), 1.0)
    ew = min_e_ea * importance
    tpw = gt.sum() - ew[gt].sum()
    fpw = ew[bg].sum()
    recall = 1.0 - ew[gt].mean()
    precision = tpw / (tpw + fpw + EPS)
    return float(
        (1.0 + beta) * recall * precision / (recall + beta * precision + EPS)
    )


# ----------------------------------------- threshold-curve metrics (Fm/Em/IoU)

@dataclasses.dataclass
class SodStats:
    """Per-image results of one shared 256-threshold sweep + adaptive pass."""

    fm_curve: np.ndarray    # (256,)
    em_curve: np.ndarray    # (256,)
    iou_curve: np.ndarray   # (256,)
    precision: np.ndarray   # (256,)
    recall: np.ndarray      # (256,)
    fm_adp: float
    em_adp: float
    iou_adp: float


def _em_from_counts(
    fg_fg: np.ndarray, fg_bg: np.ndarray, gt_fg: int, size: int
) -> np.ndarray:
    """Enhanced-alignment from confusion counts (vectorised over thresholds)."""
    pred_fg = fg_fg + fg_bg
    pred_bg = size - pred_fg
    if gt_fg == 0:
        return np.asarray(pred_bg, np.float64) / (size - 1 + EPS)
    if gt_fg == size:
        return np.asarray(pred_fg, np.float64) / (size - 1 + EPS)
    bg_fg = gt_fg - fg_fg
    bg_bg = pred_bg - bg_fg
    mean_pred = pred_fg / size
    mean_gt = gt_fg / size
    parts = (fg_fg, fg_bg, bg_fg, bg_bg)
    combos = (
        (1.0 - mean_pred, 1.0 - mean_gt),
        (1.0 - mean_pred, 0.0 - mean_gt),
        (0.0 - mean_pred, 1.0 - mean_gt),
        (0.0 - mean_pred, 0.0 - mean_gt),
    )
    total = np.zeros_like(np.asarray(pred_fg, np.float64))
    for numel, (dp, dg) in zip(parts, combos):
        align = 2.0 * dp * dg / (dp * dp + dg * dg + EPS)
        total += ((align + 1.0) ** 2 / 4.0) * numel
    return total / (size - 1 + EPS)


def threshold_curves(
    pred: np.ndarray, gt: np.ndarray, fm_beta: float = 0.3
) -> SodStats:
    """One cumulative-histogram pass -> F/E/IoU curves + adaptive values."""
    size = gt.size
    gt_fg = int(np.count_nonzero(gt))

    pred_u8 = (pred * 255).astype(np.uint8)
    bins = np.linspace(0, 256, 257)
    fg_hist, _ = np.histogram(pred_u8[gt], bins=bins)
    bg_hist, _ = np.histogram(pred_u8[~gt], bins=bins)
    tp = np.cumsum(np.flip(fg_hist))  # >=255, >=254, ..., >=0
    fp = np.cumsum(np.flip(bg_hist))

    # F-measure curve
    ps = np.where(tp + fp == 0, 1, tp + fp)
    precision = tp / ps
    recall = tp / max(gt_fg, 1)
    num = (1.0 + fm_beta) * precision * recall
    den = np.where(num == 0, 1.0, fm_beta * precision + recall)
    fm_curve = num / den

    # E-measure curve
    em_curve = _em_from_counts(tp, fp, gt_fg, size)

    # IoU curve
    fn = gt_fg - tp
    denom = np.asarray(tp + fn + fp, np.float64)
    iou_curve = np.divide(
        tp, denom, out=np.zeros_like(denom), where=denom != 0
    )

    # adaptive values
    thr = adaptive_threshold(pred)
    binarised = pred >= thr
    inter = int(np.count_nonzero(binarised & gt))
    if inter == 0:
        fm_adp = 0.0
    else:
        p = inter / np.count_nonzero(binarised)
        r = inter / gt_fg
        fm_adp = (1.0 + fm_beta) * p * r / (fm_beta * p + r)
    em_adp = float(
        _em_from_counts(
            np.asarray([inter]),
            np.asarray([int(np.count_nonzero(binarised & ~gt))]),
            gt_fg,
            size,
        )[0]
    )
    union = int(np.count_nonzero(binarised | gt))
    iou_adp = inter / union if union else 0.0

    return SodStats(
        fm_curve=fm_curve,
        em_curve=em_curve,
        iou_curve=iou_curve,
        precision=precision,
        recall=recall,
        fm_adp=float(fm_adp),
        em_adp=em_adp,
        iou_adp=float(iou_adp),
    )
