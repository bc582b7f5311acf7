"""Evaluation metrics (numpy and scipy): the port's copies of the JAX
package's `metrics/`."""

from .classification import ClassificationEvaluator, macro_f1_score
from .cod import CODMetrics, calc_cod_batch
from .ovcos import OVCOSMetricer, calc_ovcamo
from .sod import (
    SodStats,
    adaptive_threshold,
    mae_score,
    prepare_pred_gt,
    s_measure,
    threshold_curves,
    weighted_f_measure,
)
