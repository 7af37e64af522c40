"""Host-side training callbacks of the port
(JAX: tf_1d_2d_segmentation_end2endpipelines_tpu/train/callbacks.py):
EarlyStopping, ReduceLROnPlateau and best-checkpoint tracking, the
reference's Keras callback stack (2DCNN/Train.py:372-387), NaNGuard and
the per-epoch learning rate schedules.  Pure host logic between epochs,
copied from the JAX package; each stateful callback's state round-trips
through an exact-resume checkpoint's JSON sidecar.
"""
from __future__ import annotations

import math
import typing as tp


def _improved(value: float, best: float, mode: str, min_delta: float) -> bool:
    if mode == "min":
        return value < best - min_delta
    return value > best + min_delta


class _Resumable:
    """JSON-serializable callback state for exact resume (the sidecar of
    ``CheckpointManager.save_full``): every attribute in ``_STATE_KEYS``
    round-trips, so a resumed run continues patience counters, best values
    and restore budgets where the interrupted run left them."""

    _STATE_KEYS: tp.Tuple[str, ...] = ()

    def state_dict(self) -> tp.Dict[str, tp.Any]:
        return {k: getattr(self, k) for k in self._STATE_KEYS}

    def load_state_dict(self, state: tp.Dict[str, tp.Any]) -> None:
        for k in self._STATE_KEYS:
            if k in state:
                setattr(self, k, state[k])


def infer_mode(monitor: str) -> str:
    """Keras 'auto' mode: loss-like monitors minimize, everything else
    (accuracy/iou/auc...) maximizes."""
    low = monitor.lower()
    if "loss" in low or "error" in low:
        return "min"
    return "max"


class EarlyStopping(_Resumable):
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

    _STATE_KEYS = ("best", "wait", "stopped")

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


class ReduceLROnPlateau(_Resumable):
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

    _STATE_KEYS = ("best", "wait")

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


class BestTracker(_Resumable):
    """Tracks whether the current epoch is the best so far
    (ModelCheckpoint(save_best_only=True), Train.py:375-379)."""

    def __init__(self, monitor: str = "val_loss", mode: str = "auto"):
        self.monitor = monitor
        self.mode = infer_mode(monitor) if mode == "auto" else mode
        self.best = math.inf if self.mode == "min" else -math.inf

    _STATE_KEYS = ("best",)

    def is_best(self, logs: tp.Dict[str, float]) -> bool:
        value = logs.get(self.monitor)
        if value is None:
            return False
        if _improved(value, self.best, self.mode, 0.0):
            self.best = value
            return True
        return False


class NaNGuard(_Resumable):
    """Failure detection and recovery: when an epoch's loss is not
    finite, ``Trainer.fit`` restores the best checkpoint (or, without
    one, draws fresh weights), scales the learning rate down and goes on;
    training stops after ``max_restores`` rescues."""

    def __init__(self, max_restores: int = 3, lr_factor: float = 0.5):
        self.max_restores = max_restores
        self.lr_factor = lr_factor
        self.restores = 0
        self.aborted = False

    _STATE_KEYS = ("restores", "aborted")

    def check(self, logs: tp.Dict[str, float]) -> bool:
        """True if this epoch's loss is not finite (rescue needed)."""
        loss = logs.get("loss")
        return loss is not None and not math.isfinite(loss)

    def on_failure(self) -> bool:
        """Register a rescue; False when out of budget."""
        self.restores += 1
        if self.restores > self.max_restores:
            self.aborted = True
            return False
        return True


class LearningRateScheduler:
    """Per-epoch learning rate: ``schedule(epoch) -> lr``, set at the
    start of each epoch.  NaNGuard's backoff persists under a schedule
    (``Trainer.fit`` scales every scheduled rate by it);
    ReduceLROnPlateau's reduction does not (the next epoch's schedule
    overwrites it), so use one or the other."""

    def __init__(self, schedule: tp.Callable[[int], float]):
        self.schedule = schedule

    def on_epoch_begin(self, epoch: int) -> float:
        return float(self.schedule(epoch))


def cosine_decay(base_lr: float, total_epochs: int,
                 min_lr: float = 0.0, warmup_epochs: int = 0
                 ) -> tp.Callable[[int], float]:
    """Cosine decay from ``base_lr`` to ``min_lr`` over ``total_epochs``,
    after an optional linear warmup from 0."""

    def schedule(epoch: int) -> float:
        if warmup_epochs and epoch < warmup_epochs:
            return base_lr * (epoch + 1) / warmup_epochs
        t = min(max(epoch - warmup_epochs, 0),
                max(total_epochs - warmup_epochs, 1))
        frac = t / max(total_epochs - warmup_epochs, 1)
        return min_lr + (base_lr - min_lr) * 0.5 * (
            1.0 + math.cos(math.pi * frac))

    return schedule


def exponential_decay(base_lr: float, decay_rate: float,
                      decay_epochs: int = 1) -> tp.Callable[[int], float]:
    """lr = base_lr * decay_rate ** (epoch / decay_epochs)."""

    def schedule(epoch: int) -> float:
        return base_lr * decay_rate ** (epoch / max(decay_epochs, 1))

    return schedule
