"""Evaluation metrics (port of ``mertools_tpu/ops/metrics.py``), in numpy.

The JAX package takes accuracy, weighted F1 and MSE from sklearn, which the
port does not need: :func:`accuracy`, :func:`weighted_f1` and
:func:`mean_squared_error` compute sklearn's values (``accuracy_score``,
``f1_score(average="weighted")``, ``mean_squared_error``) with the same
arithmetic. The rest follows the reference:

* weighted-average F1 ("WAF") + accuracy + valence MSE per split
  (``MERBench/toolkit/dataloader/mer2023.py:137-155``);
* combined "emoval" metric = WAF - 0.25 * val_MSE (``metric.py:9-11``);
* metric selection for best-epoch picking (``metric.py:15-32``);
* cross-fold aggregation: mean of per-fold eval metrics and mean of
  per-fold test logits (``metric.py:35-99``).
"""

from __future__ import annotations

import numpy as np


def accuracy(y_true, y_pred) -> float:
    """Share of rows where the labels agree."""
    return float(np.mean(np.asarray(y_true) == np.asarray(y_pred)))


def weighted_f1(y_true, y_pred) -> float:
    """F1 per label, averaged with each label's support in ``y_true`` as
    its weight. The labels are the union of both arrays; a label predicted
    but never true has weight 0, and a label with no true positive scores 0
    (sklearn's undefined precision or recall)."""
    y_true, y_pred = np.asarray(y_true).reshape(-1), np.asarray(y_pred).reshape(-1)
    labels = np.union1d(y_true, y_pred)
    tp = np.array([np.sum((y_true == c) & (y_pred == c)) for c in labels])
    true_sum = np.array([np.sum(y_true == c) for c in labels])
    pred_sum = np.array([np.sum(y_pred == c) for c in labels])
    denom = (true_sum + pred_sum).astype(np.float64)
    f = np.divide(2.0 * tp, denom, out=np.zeros(len(labels)), where=denom != 0)
    return float(np.average(f, weights=true_sum))


def mean_squared_error(y_true, y_pred) -> float:
    """Mean of the squared differences, in the inputs' float type (float32
    stays float32 until the result, as in sklearn)."""
    y_true, y_pred = np.asarray(y_true), np.asarray(y_pred)
    dtype = np.result_type(y_true.dtype, y_pred.dtype)
    if not np.issubdtype(dtype, np.floating):
        dtype = np.float64
    diff = (y_true.astype(dtype).reshape(len(y_true), -1)
            - y_pred.astype(dtype).reshape(len(y_pred), -1))
    return float(np.mean(np.mean(diff ** 2, axis=0)))


def overall_metric(emo_fscore: float, val_mse: float) -> float:
    """Combined discriminative metric (metric.py:9-11)."""
    return emo_fscore - 0.25 * val_mse


def calculate_results(emo_probs=None, emo_labels=None,
                      val_preds=None, val_labels=None) -> dict:
    """Per-split results dict (mer2023.py:137-155 semantics)."""
    results: dict = {}
    if emo_probs is not None and len(emo_probs) > 0:
        emo_probs = np.asarray(emo_probs)
        emo_labels = np.asarray(emo_labels)
        emo_preds = emo_probs.argmax(axis=1)
        results.update(
            emoprobs=emo_probs,
            emolabels=emo_labels,
            emoacc=accuracy(emo_labels, emo_preds),
            emofscore=weighted_f1(emo_labels, emo_preds),
        )
    if val_preds is not None and len(val_preds) > 0:
        val_preds = np.asarray(val_preds).reshape(-1)
        val_labels = np.asarray(val_labels).reshape(-1)
        results.update(
            valpreds=val_preds,
            vallabels=val_labels,
            valmse=mean_squared_error(val_labels, val_preds),
        )
    return results


def gain_metric(results: dict, metric_name: str = "emoval") -> float:
    """Scalar sort metric for model selection (metric.py:15-32)."""
    if metric_name == "emoval":
        return overall_metric(results["emofscore"], results["valmse"])
    if metric_name == "emo":
        return float(results["emofscore"])
    if metric_name == "val":
        return -float(results["valmse"])
    if metric_name == "loss":
        return -float(results["loss"])
    raise ValueError(f"unknown metric {metric_name!r}")


def cv_summary(fold_results: list[dict]) -> dict:
    """Mean of eval metrics across folds (metric.py:35-54)."""
    out = {}
    for key in ("emoacc", "emofscore", "valmse"):
        vals = [fr[f"eval_{key}"] for fr in fold_results if f"eval_{key}" in fr]
        if vals:
            out[key] = float(np.mean(vals))
    return out


def cv_summary_str(summary: dict) -> str:
    parts = []
    if "emofscore" in summary:
        parts.append(f"f1:{summary['emofscore']:.4f}")
    if "emoacc" in summary:
        parts.append(f"acc:{summary['emoacc']:.4f}")
    if "valmse" in summary:
        parts.append(f"val:{summary['valmse']:.4f}")
    return "_".join(parts)


def average_folds(fold_results: list[dict], split: str) -> dict:
    """Average emo logits / val predictions across folds for one test split
    (metric.py:57-99). Test plans never shuffle, so rows align."""
    out: dict = {}
    if f"{split}_emoprobs" in fold_results[0]:
        probs = np.stack([fr[f"{split}_emoprobs"] for fr in fold_results])
        out["emoprobs"] = probs.mean(axis=0)
        out["emolabels"] = fold_results[0][f"{split}_emolabels"]
    if f"{split}_valpreds" in fold_results[0]:
        preds = np.stack([fr[f"{split}_valpreds"] for fr in fold_results])
        out["valpreds"] = preds.mean(axis=0)
        out["vallabels"] = fold_results[0][f"{split}_vallabels"]
    return out
