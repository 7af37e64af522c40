"""Reports of the ``test`` verb: confusion-matrix, ROC, precision-recall,
value-distribution and sample-grid figures, training curves, and the
results tables as CSV
(JAX: tf_1d_2d_segmentation_end2endpipelines_tpu/eval/reports.py:21-209;
reference utils/helper_functions.py:63-228 and Test.py:280-299).

matplotlib is imported inside the functions that draw, so the module
loads on a host without it; ``have_matplotlib`` tells a caller whether the
figures can be drawn.  The tables need neither pandas nor openpyxl.
"""
from __future__ import annotations

import csv
import importlib.util
import os
import typing as tp

import numpy as np


def have_matplotlib() -> bool:
    return importlib.util.find_spec("matplotlib") is not None


def _pyplot():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def _save(plt, fig, save_path: str) -> str:
    fig.tight_layout()
    fig.savefig(save_path, dpi=150)
    plt.close(fig)
    return save_path


def plot_history(history: tp.Dict[str, tp.Sequence[float]], save_path: str,
                 metric_name: tp.Optional[str] = None) -> str:
    """Loss (and one metric) training curves as a PNG
    (helper_functions.py:63-101)."""
    plt = _pyplot()
    fig, axes = plt.subplots(1, 2 if metric_name else 1,
                             figsize=(12 if metric_name else 6, 4))
    axes = np.atleast_1d(axes)
    for ax, key, title in ((axes[0], "loss", "Loss"),
                           (axes[-1], metric_name, metric_name)):
        if key is None:
            continue
        ax.plot(history.get(key, []), label="train")
        if f"val_{key}" in history:
            ax.plot(history[f"val_{key}"], label="val")
        ax.set_title(title)
        ax.set_xlabel("Epoch")
        ax.legend()
    return _save(plt, fig, save_path)


def plot_conf_mat(cm: np.ndarray, labels: tp.Sequence[str],
                  save_path: str) -> str:
    """Confusion-matrix heatmap (helper_functions.py:104-116); seaborn's
    annotated heatmap where seaborn is installed."""
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(6, 5))
    try:
        import seaborn as sns
    except ImportError:
        ax.imshow(np.asarray(cm), cmap="Blues")
    else:
        sns.heatmap(np.asarray(cm), annot=True, fmt=".0f", cmap="Blues",
                    xticklabels=labels, yticklabels=labels, ax=ax)
    ax.set_xlabel("Predicted Class")
    ax.set_ylabel("True Class")
    return _save(plt, fig, save_path)


def _roc_curve(y_true: np.ndarray, y_score: np.ndarray
               ) -> tp.Tuple[np.ndarray, np.ndarray]:
    order = np.argsort(-y_score)
    y = y_true[order]
    tps = np.cumsum(y)
    fps = np.cumsum(1 - y)
    tpr = tps / max(tps[-1], 1)
    fpr = fps / max(fps[-1], 1)
    return np.r_[0.0, fpr], np.r_[0.0, tpr]


def _class_scores(y_true: np.ndarray, y_pred: np.ndarray, c: int,
                  y_score: tp.Optional[np.ndarray]
                  ) -> tp.Tuple[np.ndarray, np.ndarray]:
    """Class ``c`` against the rest: its indicator, and its score (the
    column of ``y_score``, else the hard label's indicator)."""
    t = (np.asarray(y_true).ravel() == c).astype(np.float64)
    s = (np.asarray(y_score[:, c]).astype(np.float64)
         if y_score is not None
         else (np.asarray(y_pred).ravel() == c).astype(np.float64))
    return t, s


def plot_multiclass_roc(y_true: np.ndarray, y_pred: np.ndarray,
                        num_classes: int, save_path: str,
                        y_score: tp.Optional[np.ndarray] = None) -> str:
    """ROC per class (helper_functions.py:119-169).  Scored by the hard
    labels ``y_pred`` (two-point curves, as the reference's), or by
    ``y_score`` (N, num_classes) probabilities when given."""
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(6, 5))
    for c in range(num_classes):
        t, s = _class_scores(y_true, y_pred, c, y_score)
        if t.sum() == 0:
            continue
        fpr, tpr = _roc_curve(t, s)
        auc = float(np.trapezoid(tpr, fpr))
        ax.plot(fpr, tpr, label=f"class {c} (AUC={auc:.3f})")
    ax.plot([0, 1], [0, 1], "k--", lw=0.5)
    ax.set_xlabel("False Positive Rate")
    ax.set_ylabel("True Positive Rate")
    ax.legend()
    return _save(plt, fig, save_path)


def plot_multiclass_precision_recall_curves(
        y_true: np.ndarray, y_pred: np.ndarray, num_classes: int,
        save_path: str, y_score: tp.Optional[np.ndarray] = None) -> str:
    """Precision-recall curve per class (helper_functions.py:172-228),
    scored as ``plot_multiclass_roc``."""
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(6, 5))
    for c in range(num_classes):
        t, s = _class_scores(y_true, y_pred, c, y_score)
        if t.sum() == 0:
            continue
        y = t[np.argsort(-s)]
        tps = np.cumsum(y)
        precision = tps / np.arange(1, len(y) + 1)
        recall = tps / max(t.sum(), 1)
        ax.plot(recall, precision, label=f"class {c}")
    ax.set_xlabel("Recall")
    ax.set_ylabel("Precision")
    ax.legend()
    return _save(plt, fig, save_path)


def _write_table(path: str, columns: tp.Sequence[str],
                 index: tp.Sequence[str], rows: np.ndarray) -> None:
    # pandas' DataFrame.to_csv layout: an empty corner cell, the column
    # names, then one row per index label; floats as Python prints them
    with open(path, "w", newline="") as f:
        writer = csv.writer(f, lineterminator="\n")
        writer.writerow(["", *columns])
        for name, row in zip(index, np.asarray(rows, np.float64)):
            writer.writerow([name, *(repr(float(v)) for v in row)])


def export_results_sheet(report: tp.Dict[str, tp.Any], save_path: str
                         ) -> str:
    """The evaluation table (with its weighted average) and the confusion
    matrix as ``<base>_results.csv`` and ``<base>_confusion_matrix.csv``,
    ``<base>`` being ``save_path`` without its extension: the files the
    JAX package writes where openpyxl is missing (Test.py:280-299 writes
    one .xlsx).  Returns the results table's path."""
    base = os.path.splitext(save_path)[0]
    _write_table(base + "_results.csv", report["headers"],
                 list(report["labels"]) + ["Weighted Average"],
                 np.vstack([report["per_class"],
                            report["weighted_average"]]))
    _write_table(base + "_confusion_matrix.csv", report["labels"],
                 report["labels"], report["confusion_matrix"])
    return base + "_results.csv"


def plot_prediction_distributions(y_true, y_pred, save_path: str) -> str:
    """Ground truth against prediction: value distributions and violins
    (2D_Segmentation_TF.ipynb cells 72-74); seaborn's KDE where seaborn
    is installed, histograms otherwise."""
    plt = _pyplot()
    t = np.asarray(y_true).ravel()
    p = np.asarray(y_pred).ravel()
    fig, axes = plt.subplots(1, 2, figsize=(10, 4))
    try:
        import seaborn as sns
    except ImportError:
        axes[0].hist(t, bins=50, alpha=0.5, label="ground truth",
                     density=True)
        axes[0].hist(p, bins=50, alpha=0.5, label="prediction",
                     density=True)
        axes[1].violinplot([t, p])
    else:
        sns.kdeplot(t, ax=axes[0], label="ground truth", fill=True)
        sns.kdeplot(p, ax=axes[0], label="prediction", fill=True)
        sns.violinplot(data=[t, p], ax=axes[1])
        axes[1].set_xticks([0, 1], ["ground truth", "prediction"])
    axes[0].legend()
    axes[0].set_title("Value distribution")
    axes[1].set_title("Violin")
    return _save(plt, fig, save_path)


def plot_sample_grid(images, masks, preds, save_path: str,
                     max_samples: int = 4) -> str:
    """Image, ground truth and prediction side by side, one row per sample
    (notebook cells 77-78)."""
    plt = _pyplot()
    n = min(len(images), max_samples)
    fig, axes = plt.subplots(n, 3, figsize=(9, 3 * n), squeeze=False)
    for i in range(n):
        img = np.asarray(images[i])
        panels = ((img, "gray" if img.shape[-1] == 1 else None, "image"),
                  (masks[i], "viridis", "ground truth"),
                  (preds[i], "viridis", "prediction"))
        for ax, (a, cmap, title) in zip(axes[i], panels):
            ax.imshow(np.asarray(a).squeeze(), cmap=cmap)
            ax.set_title(title)
            ax.axis("off")
    return _save(plt, fig, save_path)
