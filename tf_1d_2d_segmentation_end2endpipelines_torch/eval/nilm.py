"""1D signal (NILM-style) evaluation metrics (JAX: tf_1d_2d_segmentation_
end2endpipelines_tpu/eval/nilm.py:19-94; reference 1DCNN/
1D_Segmentation.ipynb cells 51-63).  Host numpy over fetched predictions,
rounded as the JAX functions round; the energy overlap indices sum in
float32, as the JAX package's jitted reductions do."""
from __future__ import annotations

import typing as tp

import numpy as np


def construction_error(ground: np.ndarray, pred: np.ndarray
                       ) -> tp.Dict[str, float]:
    """Per-sample MAE/MSE/RMSE/Pearson, averaged over samples (cell 51).
    Samples where either side has zero variance are skipped, as in the
    reference."""
    maes, mses, rmses, ccs = [], [], [], []
    for g, p in zip(np.asarray(ground), np.asarray(pred)):
        g = g.ravel().astype(np.float64)
        p = p.ravel().astype(np.float64)
        if np.std(p) == 0 or np.std(g) == 0:
            continue
        err = p - g
        maes.append(np.mean(np.abs(err)))
        mses.append(np.mean(err ** 2))
        rmses.append(np.sqrt(np.mean(err ** 2)))
        ccs.append(np.corrcoef(p, g)[0, 1])
    return {
        "MAE": round(float(np.mean(maes)), 3) if maes else float("nan"),
        "MSE": round(float(np.mean(mses)), 3) if mses else float("nan"),
        "RMSE": round(float(np.mean(rmses)), 3) if rmses else float("nan"),
        "PCC": round(float(np.mean(ccs)) * 100, 3) if ccs else float("nan"),
    }


def calculate_sae(ground: np.ndarray, pred: np.ndarray) -> float:
    """Signal Aggregate Error: |sum(pred) - sum(ground)| / sum(ground)
    (cell 54)."""
    eg = float(np.sum(ground))
    ep = float(np.sum(pred))
    return round(abs(ep - eg) / eg, 3)


def calculate_ea(ground: np.ndarray, pred: np.ndarray) -> float:
    """Estimation Accuracy: mean_i [1 - sum|g-p| / (2*sum g)] (cell 57)."""
    vals = []
    for g, p in zip(np.asarray(ground), np.asarray(pred)):
        g = g.ravel().astype(np.float64)
        p = p.ravel().astype(np.float64)
        vals.append(1.0 - np.sum(np.abs(g - p)) / (2.0 * np.sum(g)))
    return round(float(np.mean(vals)), 3)


def _eo_ee_em(g: np.ndarray, p: np.ndarray
              ) -> tp.Tuple[np.float32, np.float32, np.float32]:
    """Energy overlap, excess and miss of one sample, in float32 (the
    notebook's branch logic over (g, p >= 0) reduces to these sums)."""
    g = np.asarray(g, np.float32).ravel()
    p = np.maximum(np.asarray(p, np.float32).ravel(), np.float32(0))
    eo = np.sum(np.minimum(g, p), dtype=np.float32)
    ee = np.sum(np.maximum(p - g, np.float32(0)), dtype=np.float32)
    em = np.sum(np.maximum(g - p, np.float32(0)), dtype=np.float32)
    return eo, ee, em


def calculate_jeoi(ground: np.ndarray, pred: np.ndarray) -> float:
    """Jaccard-style Energy Overlap Index (cell 60)."""
    vals = []
    for g, p in zip(np.asarray(ground), np.asarray(pred)):
        eo, ee, em = _eo_ee_em(g, p)
        vals.append(float(eo / (eo + ee + em)))
    return round(float(np.mean(vals)), 4)


def calculate_deoi(ground: np.ndarray, pred: np.ndarray) -> float:
    """Dice-style Energy Overlap Index (cell 63)."""
    vals = []
    for g, p in zip(np.asarray(ground), np.asarray(pred)):
        eo, ee, em = _eo_ee_em(g, p)
        vals.append(float((2 * eo) / (2 * eo + ee + em)))
    return round(float(np.mean(vals)), 4)
