"""Trainer of the port: the replacement for Keras ``compile``/``fit``
(JAX: tf_1d_2d_segmentation_end2endpipelines_tpu/train/trainer.py,
``Trainer.__init__`` :71, ``fit`` :198, ``evaluate`` :467 and ``predict``
:481).

One device.  Per step: host batch to the device, the targets built from
the mask there (``prepare_targets``: the deep-supervision pyramid), one
train step; the losses and metric states stay on the device until the
epoch ends, when one read brings the epoch's scalars to the host.  Callbacks
(EarlyStopping, ReduceLROnPlateau, the best checkpoint) run between
epochs, as in the JAX package.  Not ported yet: exact resume and
TensorBoard scalars (the INI keys that ask for them are refused by
``utils/config.py``'s ``unported_train_keys``), profiling, NaNGuard and
learning rate schedules.
"""
from __future__ import annotations

import time
import typing as tp

import numpy as np
import torch

from ..eval.tta import make_tta_fn
from .callbacks import BestTracker, EarlyStopping, ReduceLROnPlateau
from .checkpoint import CheckpointManager
from .losses import get_loss
from .metrics import Metric, make_metric
from .optimizers import get_learning_rate, make_optimizer, set_learning_rate
from .state import (Targets, make_eval_step, make_predict_step,
                    make_train_step)

BatchIter = tp.Callable[[], tp.Iterable[tp.Tuple[np.ndarray, np.ndarray]]]


class Trainer:
    def __init__(
        self,
        model: torch.nn.Module,
        loss: str = "BinaryCrossentropy",
        optimizer: str = "Adam",
        learning_rate: float = 3e-4,
        metrics: tp.Sequence[str] = (),
        loss_weights: tp.Optional[tp.Dict[str, float]] = None,
        num_classes: int = 2,
        device: tp.Union[str, torch.device] = "cuda",
        prepare_targets: tp.Optional[
            tp.Callable[[torch.Tensor], Targets]] = None,
        clipnorm: float = 0.0,
        clipvalue: float = 0.0,
        global_clipnorm: float = 0.0,
    ):
        """``model`` is moved to ``device``; the optimizer is built over
        its parameters there, its gradients clipped as ``clipnorm``,
        ``clipvalue`` and ``global_clipnorm`` say (0 = off).
        ``num_classes`` sizes the IoU metrics.  ``prepare_targets`` maps a
        mask batch, on the device, to the step's targets (default: the
        mask is the ``out`` target)."""
        self.device = torch.device(device)
        self.prepare_targets = prepare_targets
        self.model = model.to(self.device)
        self.loss_fn = get_loss(loss)
        self.optimizer = make_optimizer(
            optimizer, self.model.parameters(), learning_rate,
            clipnorm=clipnorm, clipvalue=clipvalue,
            global_clipnorm=global_clipnorm)
        self.metric_defs: tp.List[Metric] = [
            make_metric(m, num_classes=num_classes) for m in metrics]
        self.train_step = make_train_step(self.model, self.optimizer,
                                          self.loss_fn, loss_weights,
                                          self.metric_defs)
        self.eval_step = make_eval_step(self.model, self.loss_fn,
                                        loss_weights, self.metric_defs)
        self.predict_step = make_predict_step(self.model)
        self.history: tp.Dict[str, tp.List[float]] = {}

    def to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _batch(self, x: np.ndarray, y: np.ndarray
               ) -> tp.Tuple[torch.Tensor, Targets]:
        x, y = self.to_device(x), self.to_device(y)
        if self.prepare_targets is not None:
            y = self.prepare_targets(y)
        return x, y

    def _metric_init(self) -> tp.Tuple:
        return tuple(m.init(self.device) for m in self.metric_defs)

    def _metric_results(self, states) -> tp.Dict[str, float]:
        return {m.name: float(m.result(s))
                for m, s in zip(self.metric_defs, states)}

    def fit(
        self,
        train_data: BatchIter,
        val_data: tp.Optional[BatchIter] = None,
        epochs: int = 1,
        callbacks: tp.Sequence = (),
        checkpoint: tp.Optional[CheckpointManager] = None,
        monitor: str = "val_loss",
        verbose: int = 1,
    ) -> tp.Dict[str, tp.List[float]]:
        """Train ``epochs`` epochs; returns the history: ``loss``,
        ``steps_per_sec``, the metrics, ``val_loss`` and ``val_<metric>``
        when there is validation data, ``lr`` and ``epoch_time`` per epoch
        (the JAX ``fit``'s keys)."""
        for cb in callbacks:
            if not isinstance(cb, (EarlyStopping, ReduceLROnPlateau)):
                raise NotImplementedError(
                    f"callback {type(cb).__name__} is not ported yet "
                    "(ported: EarlyStopping, ReduceLROnPlateau)")
        early = next((c for c in callbacks if isinstance(c, EarlyStopping)),
                     None)
        rlrop = next((c for c in callbacks
                      if isinstance(c, ReduceLROnPlateau)), None)
        best = BestTracker(monitor) if checkpoint is not None else None

        for epoch in range(epochs):
            t0 = time.time()
            # -------- train epoch --------
            mstates = self._metric_init()
            losses = []
            for x, y in train_data():
                loss, mstates = self.train_step(*self._batch(x, y), mstates)
                losses.append(loss)
            logs: tp.Dict[str, float] = {}
            if losses:
                logs["loss"] = float(torch.stack(losses).mean())
                logs["steps_per_sec"] = len(losses) / max(time.time() - t0,
                                                          1e-9)
            logs.update(self._metric_results(mstates))
            # -------- validation epoch --------
            if val_data is not None:
                logs.update({f"val_{k}": v
                             for k, v in self.evaluate(val_data).items()})
            logs["lr"] = get_learning_rate(self.optimizer)
            logs["epoch_time"] = time.time() - t0
            for k, v in logs.items():
                self.history.setdefault(k, []).append(v)
            if verbose:
                msg = " - ".join(f"{k}: {v:.5g}" for k, v in logs.items())
                print(f"Epoch {epoch + 1}/{epochs} [{len(losses)} steps] "
                      f"{msg}", flush=True)
            # -------- callbacks --------
            if best is not None and best.is_best(logs):
                checkpoint.save(self.model, self.optimizer, "best")
            if rlrop is not None:
                new_lr = rlrop.on_epoch_end(epoch, logs, logs["lr"])
                if new_lr != logs["lr"]:
                    set_learning_rate(self.optimizer, new_lr)
            if early is not None:
                early.on_epoch_end(epoch, logs)
                if early.stopped:
                    if verbose:
                        print(f"Early stopping at epoch {epoch + 1}",
                              flush=True)
                    break
        return self.history

    def evaluate(self, data: BatchIter) -> tp.Dict[str, float]:
        """The eval-mode loss (mean over the batches) and metrics of
        ``data``."""
        mstates = self._metric_init()
        losses = []
        for x, y in data():
            loss, _, mstates = self.eval_step(*self._batch(x, y), mstates)
            losses.append(loss)
        logs = {"loss": float(torch.stack(losses).mean())} if losses else {}
        logs.update(self._metric_results(mstates))
        return logs

    def predict(self, x: np.ndarray, tta: tp.Sequence[str] = ()
                ) -> tp.Dict[str, np.ndarray]:
        """Every head of the eval-mode forward of the NHWC batch ``x`` on
        the trainer's device, as float32 numpy arrays.  ``tta`` names views
        (eval.tta.TTA_2D) to average over; all views of the batch run as
        one forward."""
        step = make_tta_fn(self.predict_step, tta)
        with torch.inference_mode():
            out = step(self.to_device(x))
            return {k: v.float().cpu().numpy() for k, v in out.items()}
