"""Host-side training callbacks of the port
(JAX: tf_1d_2d_segmentation_end2endpipelines_tpu/train/callbacks.py):
EarlyStopping, ReduceLROnPlateau and best-checkpoint tracking, the
reference's Keras callback stack (2DCNN/Train.py:372-387).  Pure host
logic between epochs, copied from the JAX package.
"""
from __future__ import annotations

import math
import typing as tp


def _improved(value: float, best: float, mode: str, min_delta: float) -> bool:
    if mode == "min":
        return value < best - min_delta
    return value > best + min_delta


def infer_mode(monitor: str) -> str:
    """Keras 'auto' mode: loss-like monitors minimize, everything else
    (accuracy/iou/auc...) maximizes."""
    low = monitor.lower()
    if "loss" in low or "error" in low:
        return "min"
    return "max"


class EarlyStopping:
    """Stop when ``monitor`` stops improving (Train.py:373-374)."""

    def __init__(self, monitor: str = "val_loss", patience: int = 10,
                 min_delta: float = 0.0, mode: str = "auto"):
        self.monitor = monitor
        self.patience = patience
        self.min_delta = min_delta
        self.mode = infer_mode(monitor) if mode == "auto" else mode
        self.best = math.inf if self.mode == "min" else -math.inf
        self.wait = 0
        self.stopped = False

    def on_epoch_end(self, epoch: int, logs: tp.Dict[str, float]) -> None:
        value = logs.get(self.monitor)
        if value is None:
            return
        if _improved(value, self.best, self.mode, self.min_delta):
            self.best = value
            self.wait = 0
        else:
            self.wait += 1
            if self.wait >= self.patience:
                self.stopped = True


class ReduceLROnPlateau:
    """Scale LR by ``factor`` after ``patience`` stagnant epochs
    (Train.py:381-385; factor/patience/min_lr from the INI config)."""

    def __init__(self, monitor: str = "val_loss", factor: float = 0.1,
                 patience: int = 5, min_lr: float = 1e-6,
                 min_delta: float = 1e-4, mode: str = "auto"):
        self.monitor = monitor
        self.factor = factor
        self.patience = patience
        self.min_lr = min_lr
        self.min_delta = min_delta
        self.mode = infer_mode(monitor) if mode == "auto" else mode
        self.best = math.inf if self.mode == "min" else -math.inf
        self.wait = 0

    def on_epoch_end(self, epoch: int, logs: tp.Dict[str, float],
                     current_lr: float) -> float:
        """Returns the (possibly reduced) learning rate."""
        value = logs.get(self.monitor)
        if value is None:
            return current_lr
        if _improved(value, self.best, self.mode, self.min_delta):
            self.best = value
            self.wait = 0
            return current_lr
        self.wait += 1
        if self.wait >= self.patience:
            self.wait = 0
            return max(current_lr * self.factor, self.min_lr)
        return current_lr


class BestTracker:
    """Tracks whether the current epoch is the best so far
    (ModelCheckpoint(save_best_only=True), Train.py:375-379)."""

    def __init__(self, monitor: str = "val_loss", mode: str = "auto"):
        self.monitor = monitor
        self.mode = infer_mode(monitor) if mode == "auto" else mode
        self.best = math.inf if self.mode == "min" else -math.inf

    def is_best(self, logs: tp.Dict[str, float]) -> bool:
        value = logs.get(self.monitor)
        if value is None:
            return False
        if _improved(value, self.best, self.mode, 0.0):
            self.best = value
            return True
        return False
