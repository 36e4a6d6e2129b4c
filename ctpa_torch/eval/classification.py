"""Classification evaluation: per-label ROC/AUROC, PR curves, Youden operating
point, bootstrap confidence intervals (port of
``ctpa/eval/classification.py``).

ctpa computes these with sklearn and returns DataFrames; the card's machine
has neither sklearn nor pandas, so here they are numpy and the results are
plain tables: dicts of columns (lists) with ctpa's column names in ctpa's
order.  ``roc_curve`` is sklearn's (``drop_intermediate=True``, a leading
``inf`` threshold), so the Youden threshold is the one ctpa picks, and AUROC
is sklearn's trapezoidal area under it, computed as ``numpy.trapz`` does, so
it equals ctpa's bit for bit and the tables write the same bytes.
``table_json`` prints a table as pandas' ``DataFrame.to_json()`` does.  The
ROC/PR plots are drawn when ``matplotlib`` imports and skipped, with a note
on stderr, where it does not; every number is computed either way.
"""

from __future__ import annotations

import json
import math
import os
import sys
from typing import Optional, Sequence

import numpy as np


def roc_auc(y_true: np.ndarray, y_score: np.ndarray) -> float:
    """Area under the ROC curve of the scores against 0/1 labels; NaN when
    the labels hold one class."""
    if len(np.unique(np.asarray(y_true))) < 2:
        return float("nan")
    fpr, tpr, _ = roc_curve(y_true, y_score)
    return float((np.diff(fpr) * (tpr[1:] + tpr[:-1]) / 2.0).sum())


def _binary_clf_curve(y_true, y_score):
    """(fps, tps, thresholds) at each distinct score, highest first
    (sklearn's ``_binary_clf_curve``, positive label 1, unit weights)."""
    y_true = np.asarray(y_true) == 1
    y_score = np.asarray(y_score)
    desc = np.argsort(y_score, kind="mergesort")[::-1]
    y_score, y_true = y_score[desc], y_true[desc]
    distinct = np.where(np.diff(y_score))[0]
    threshold_idxs = np.r_[distinct, y_true.size - 1]
    tps = np.cumsum(y_true, dtype=np.float64)[threshold_idxs]
    fps = 1 + threshold_idxs - tps
    return fps, tps, y_score[threshold_idxs]


def roc_curve(y_true, y_score):
    """(fpr, tpr, thresholds) as ``sklearn.metrics.roc_curve`` gives them:
    collinear points dropped, a first point (0, 0) at threshold ``inf``."""
    fps, tps, thresholds = _binary_clf_curve(y_true, y_score)
    if len(fps) > 2:
        keep = np.where(np.r_[True, np.logical_or(np.diff(fps, 2), np.diff(tps, 2)), True])[0]
        fps, tps, thresholds = fps[keep], tps[keep], thresholds[keep]
    tps, fps = np.r_[0, tps], np.r_[0, fps]
    thresholds = np.r_[np.inf, thresholds]
    return fps / fps[-1], tps / tps[-1], thresholds


def precision_recall_curve(y_true, y_score):
    """(precision, recall, thresholds) as sklearn's ``precision_recall_curve``."""
    fps, tps, thresholds = _binary_clf_curve(y_true, y_score)
    ps = tps + fps
    precision = np.zeros_like(tps)
    np.divide(tps, ps, out=precision, where=ps != 0)
    recall = np.ones_like(tps) if tps[-1] == 0 else tps / tps[-1]
    return np.r_[precision[::-1], 1], np.r_[recall[::-1], 0], thresholds[::-1]


def choose_operating_point(fpr: np.ndarray, tpr: np.ndarray, thresholds: np.ndarray):
    """Youden J = max(tpr - fpr)."""
    j = tpr - fpr
    ix = int(np.argmax(j))
    return float(thresholds[ix]), float(fpr[ix]), float(tpr[ix])


def evaluate_classification(
    predictions: np.ndarray,            # (n, L) probabilities / scores
    labels: np.ndarray,                 # (n, L) one-hot ground truth
    label_names: Sequence[str],
    plot_dir: Optional[str] = None,
) -> dict[str, list]:
    """One-row table {"<name>_auc": [auc], ..., "mean_auc": [mean]}, and the
    ROC/PR plots under ``plot_dir`` where matplotlib is installed."""
    table = {}
    plot = plot_dir is not None and _matplotlib_or_note(plot_dir)
    for i, name in enumerate(label_names):
        y, s = labels[:, i], predictions[:, i]
        auc = roc_auc(y, s)
        table[f"{name}_auc"] = [auc]
        if plot and np.isfinite(auc):
            _plot_roc_pr(y, s, name, plot_dir)
    mean_auc = np.nanmean([v[0] for v in table.values()]) if table else float("nan")
    table["mean_auc"] = [float(mean_auc)]
    return table


def _matplotlib_or_note(plot_dir: str) -> bool:
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        print(f"evaluate_classification: matplotlib is not installed; the ROC/PR plots "
              f"for {plot_dir} are skipped (every number is still computed)", file=sys.stderr)
        return False
    return True


def _plot_roc_pr(y, s, name, plot_dir):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(plot_dir, exist_ok=True)
    fpr, tpr, thr = roc_curve(y, s)
    op_thr, op_fpr, op_tpr = choose_operating_point(fpr, tpr, thr)
    fig, ax = plt.subplots(1, 2, figsize=(10, 4))
    ax[0].plot(fpr, tpr)
    ax[0].plot([0, 1], [0, 1], "k--")
    ax[0].scatter([op_fpr], [op_tpr], c="r", label=f"Youden thr={op_thr:.3f}")
    ax[0].set_title(f"ROC {name} (AUC {np.trapezoid(tpr, fpr):.3f})")
    ax[0].legend()
    prec, rec, _ = precision_recall_curve(y, s)
    ax[1].plot(rec, prec)
    ax[1].set_title(f"PR {name}")
    fig.tight_layout()
    fig.savefig(os.path.join(plot_dir, f"{name.replace(' ', '_')}_roc_pr.png"))
    plt.close(fig)


def bootstrap_cis(
    predictions: np.ndarray,
    labels: np.ndarray,
    label_names: Sequence[str],
    n_samples: int = 1000,
    confidence: float = 0.95,
    seed: int = 0,
) -> dict[str, list]:
    """Bootstrap AUROC confidence intervals: resample rows with replacement
    (the draws of ctpa's ``default_rng(seed)``), recompute per-label AUROC,
    report the (lower, mid, upper) quantiles.  Columns label, lower, mid,
    upper."""
    rng = np.random.default_rng(seed)
    n = predictions.shape[0]
    boots = []
    for _ in range(n_samples):
        idx = rng.integers(0, n, size=n)
        boots.append([roc_auc(labels[idx, i], predictions[idx, i])
                      for i in range(len(label_names))])
    arr = np.asarray(boots)  # (n_samples, L)
    lo = (1 - confidence) / 2
    table = {"label": [], "lower": [], "mid": [], "upper": []}
    for i, name in enumerate(label_names):
        col = arr[:, i]
        col = col[np.isfinite(col)]
        q = ([np.nan] * 3 if len(col) == 0
             else [float(np.quantile(col, p)) for p in (lo, 0.5, 1 - lo)])
        for key, val in zip(("label", "lower", "mid", "upper"), [name] + q):
            table[key].append(val)
    return table


def accuracy_f1_at_youden(predictions: np.ndarray, labels: np.ndarray,
                          label_names: Sequence[str]) -> dict[str, list]:
    """Threshold each label at its Youden point, report accuracy/F1/precision/
    recall (zero where a ratio's denominator is zero).  Columns label,
    accuracy, f1, precision, recall."""
    table = {"label": [], "accuracy": [], "f1": [], "precision": [], "recall": []}
    for i, name in enumerate(label_names):
        y, s = labels[:, i], predictions[:, i]
        if len(np.unique(y)) < 2:
            row = [np.nan] * 4
        else:
            fpr, tpr, thr = roc_curve(y, s)
            t, _, _ = choose_operating_point(fpr, tpr, thr)
            pred = s >= t
            pos = y == 1
            tp = float(np.sum(pred & pos))
            n_pred, n_pos = float(pred.sum()), float(pos.sum())
            precision = tp / n_pred if n_pred else 0.0
            recall = tp / n_pos if n_pos else 0.0
            f1 = 2 * tp / (n_pred + n_pos) if n_pred + n_pos else 0.0
            row = [float(np.mean(pred == pos)), f1, precision, recall]
        for key, val in zip(("label", "accuracy", "f1", "precision", "recall"), [name] + row):
            table[key].append(val)
    return table


def table_rows(table: dict[str, list]) -> list[dict]:
    """A dict of columns as rows, for ``data.manifests.write_csv``."""
    return [dict(zip(table, vals)) for vals in zip(*table.values())]


def _json_float(value: float) -> str:
    """A float as pandas' ujson writes it at ``double_precision=10``: fixed
    point with at most 10 decimals (the last rounded half to odd, trailing
    zeros dropped, at least one), ``%.10g`` below 1e-15 or from 1e16 on,
    ``null`` for NaN."""
    if math.isnan(value):
        return "null"
    if math.isinf(value):
        raise ValueError("pandas refuses an infinite value in to_json")
    neg, value = value < 0, abs(value)
    if value > 1e16 - 1 or (value != 0.0 and value < 1e-15):
        return "%.10g" % (-value if neg else value)
    whole = int(value)
    tmp = (value - whole) * 1e10
    frac = int(tmp)
    diff = tmp - frac
    if diff > 0.5 or (diff == 0.5 and (frac == 0 or frac & 1)):
        frac += 1
    if frac >= 10 ** 10:
        frac, whole = 0, whole + 1
    text = f"{whole}." + (f"{frac:010d}".rstrip("0") or "0")
    return "-" + text if neg else text


def table_json(table: dict[str, list]) -> str:
    """``pd.DataFrame(table).to_json()`` (orient "columns", a RangeIndex) for
    a table of float columns."""
    def key(name):
        return json.dumps(str(name)).replace("/", "\\/")

    cols = (f"{key(name)}:{{" + ",".join(f'"{i}":{_json_float(float(v))}'
                                          for i, v in enumerate(vals)) + "}"
            for name, vals in table.items())
    return "{" + ",".join(cols) + "}"
