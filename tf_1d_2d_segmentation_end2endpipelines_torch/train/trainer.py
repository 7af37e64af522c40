"""Trainer of the port: the replacement for Keras ``compile``/``fit``
(JAX: tf_1d_2d_segmentation_end2endpipelines_tpu/train/trainer.py,
``Trainer.__init__`` :71, ``fit`` :198, ``evaluate`` :467 and ``predict``
:481).

One device.  Per step: host batch to the device, the targets built from
the mask there (``prepare_targets``: the deep-supervision pyramid), one
train step (with gradient accumulation, rematerialization and an EMA
shadow when asked); the losses and metric states stay on the device until
the epoch ends, when one read brings the epoch's scalars to the host.
Callbacks (EarlyStopping, ReduceLROnPlateau, NaNGuard, a learning rate
schedule, the best checkpoint) run between epochs, as in the JAX package;
so do the TensorBoard scalars, a ``torch.profiler`` trace of one epoch and
the exact-resume checkpoint.
"""
from __future__ import annotations

import os
import time
import typing as tp

import numpy as np
import torch

from ..eval.tta import make_tta_fn
from ..utils.rng import generator as keyed_generator
from .callbacks import (BestTracker, EarlyStopping, LearningRateScheduler,
                        NaNGuard, ReduceLROnPlateau)
from .checkpoint import CheckpointManager
from .losses import get_loss
from .metrics import Metric, make_metric
from .optimizers import get_learning_rate, make_optimizer, set_learning_rate
from .state import (Targets, ema_shadow, make_eval_step, make_predict_step,
                    make_train_step)

BatchIter = tp.Callable[[], tp.Iterable[tp.Tuple[tp.Any, tp.Any]]]


class _PreemptionWatch:
    """SIGTERM watch for preemption-safe training (JAX :35-60): the handler
    only sets a flag, which the fit loop reads at step boundaries.  Signal
    handlers need the main thread; elsewhere the watch does nothing."""

    def __init__(self, signals=None):
        import signal as _signal
        self._signal = _signal
        self.triggered = False
        self._prev: tp.Dict[int, tp.Any] = {}
        for s in signals if signals is not None else (_signal.SIGTERM,):
            try:
                self._prev[s] = _signal.signal(s, self._handler)
            except ValueError:  # not the main thread
                pass

    def _handler(self, signum, frame):
        self.triggered = True

    def restore(self):
        for s, h in self._prev.items():
            self._signal.signal(s, h)


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
        seed: int = 42,
        remat: tp.Optional[str] = None,
        accum_steps: int = 1,
        ema_decay: float = 0.0,
    ):
        """``model`` is moved to ``device``; the optimizer is built over
        its parameters there, its gradients clipped as ``clipnorm``,
        ``clipvalue`` and ``global_clipnorm`` say (0 = off).
        ``num_classes`` sizes the IoU metrics.  ``prepare_targets`` maps a
        mask batch, on the device, to the step's targets (default: the
        mask is the ``out`` target).  ``remat``, ``accum_steps`` and
        ``ema_decay`` go to the train step (``make_train_step``); with
        ``ema_decay`` > 0 validation, ``evaluate``, ``predict`` and the
        best checkpoint's selection run on the EMA shadow.  ``seed`` keys
        NaNGuard's re-initialization and, with the step count, the
        stochastic layers' draws (``make_train_step``)."""
        if not 0.0 <= ema_decay < 1.0:
            raise ValueError(f"ema_decay must be in [0, 1), got {ema_decay}")
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
        self.seed = seed
        #: the EMA shadow (float32 copies of the parameters) or None
        self.ema = ema_shadow(self.model) if ema_decay > 0 else None
        #: optimizer updates so far (the full checkpoint's pairing token)
        self.step = 0
        self.preempted = False
        self.train_step = make_train_step(
            self.model, self.optimizer, self.loss_fn, loss_weights,
            self.metric_defs, remat=remat, accum_steps=accum_steps,
            ema=self.ema, ema_decay=ema_decay, seed=seed)
        self.eval_step = make_eval_step(self.model, self.loss_fn,
                                        loss_weights, self.metric_defs,
                                        ema=self.ema)
        self.predict_step = make_predict_step(self.model, ema=self.ema)
        self.history: tp.Dict[str, tp.List[float]] = {}

    def to_device(self, a: tp.Any) -> torch.Tensor:
        if isinstance(a, torch.Tensor):
            return a.to(self.device)
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _batch(self, x, y) -> tp.Tuple[torch.Tensor, Targets]:
        x, y = self.to_device(x), self.to_device(y)
        if self.prepare_targets is not None:
            y = self.prepare_targets(y)
        return x, y

    def _metric_init(self) -> tp.Tuple:
        return tuple(m.init(self.device) for m in self.metric_defs)

    def _metric_results(self, states, prefix: str = "") -> tp.Dict[str, float]:
        return {prefix + m.name: float(m.result(s))
                for m, s in zip(self.metric_defs, states)}

    def _reinitialize(self, epoch: int) -> None:
        """Fresh weights, optimizer state, shadow and step count: weights
        drawn from a ``torch.Generator`` keyed by ``(seed, epoch + 1)``
        (the JAX trainer folds the same pair into a threefry key, :417-421,
        whose draws the port cannot reproduce)."""
        fresh = self.model.reinitialized(keyed_generator(self.seed,
                                                         epoch + 1))
        self.model.load_state_dict(fresh.state_dict())
        self.optimizer.state.clear()
        if self.ema is not None:
            with torch.no_grad():
                for e, p in zip(self.ema, self.model.parameters()):
                    e.copy_(p)
        self.step = 0

    def fit(
        self,
        train_data: BatchIter,
        val_data: tp.Optional[BatchIter] = None,
        epochs: int = 1,
        callbacks: tp.Sequence = (),
        checkpoint: tp.Optional[CheckpointManager] = None,
        monitor: str = "val_loss",
        verbose: int = 1,
        profile_dir: tp.Optional[str] = None,
        profile_epoch: int = 1,
        tensorboard_dir: tp.Optional[str] = None,
        exact_resume: bool = False,
        resume_token: tp.Optional[str] = None,
    ) -> tp.Dict[str, tp.List[float]]:
        """Train up to ``epochs`` epochs; returns the history: ``loss``,
        ``steps_per_sec``, the metrics, ``val_loss`` and ``val_<metric>``
        when there is validation data, ``lr`` and ``epoch_time`` per epoch
        (the JAX ``fit``'s keys).

        ``tensorboard_dir`` writes each epoch's scalars there (tag = the
        history key, step = the epoch).  ``profile_dir`` keeps a
        ``torch.profiler`` trace of epoch ``profile_epoch`` there
        (``trace.json``).

        ``exact_resume`` (needs ``checkpoint``) makes the run resumable:
        a full ``last`` checkpoint (weights, optimizer state, step count,
        shadow, and in its sidecar the epoch, history, ``lr_scale``, the
        callbacks' state and ``resume_token``) is written when the run
        starts and after every epoch; a later ``fit`` with the same token
        continues from the recorded epoch, the train loader's
        ``set_epoch`` replaying its data order.  A SIGTERM stops the run
        at the next step boundary, or abandons the validation pass it
        lands in, sets ``preempted`` and returns: ``last`` then holds the
        state the interrupted epoch started from, which the resumed run
        trains again, so the resumed run equals an uninterrupted one.
        (The JAX trainer saves the partial epoch's weights instead and
        trains that epoch again on top of them.)"""
        tb = None
        if tensorboard_dir:
            from torch.utils.tensorboard import SummaryWriter
            tb = SummaryWriter(tensorboard_dir)
        early = next((c for c in callbacks if isinstance(c, EarlyStopping)),
                     None)
        rlrop = next((c for c in callbacks
                      if isinstance(c, ReduceLROnPlateau)), None)
        guard = next((c for c in callbacks if isinstance(c, NaNGuard)), None)
        sched = next((c for c in callbacks
                      if isinstance(c, LearningRateScheduler)), None)
        best = BestTracker(monitor) if checkpoint is not None else None
        # NaNGuard's backoffs accumulate into lr_scale, which scales every
        # scheduled rate (JAX :245-248)
        lr_scale = 1.0
        self.preempted = False
        named_cbs = {"early": early, "rlrop": rlrop, "nan_guard": guard,
                     "best": best}
        start_epoch = 0
        watch = None
        if exact_resume and checkpoint is None:
            raise ValueError("exact_resume=True requires a checkpoint")

        def save_last(next_epoch: int, stopped: bool = False) -> None:
            if not exact_resume:
                return
            checkpoint.save_full(
                self.model, self.optimizer, self.step, "last", ema=self.ema,
                meta={"epoch": next_epoch, "history": self.history,
                      "lr_scale": lr_scale, "stopped": stopped,
                      "config": resume_token,
                      "callbacks": {k: cb.state_dict()
                                    for k, cb in named_cbs.items()
                                    if cb is not None}})

        if exact_resume:
            watch = _PreemptionWatch()
            meta = checkpoint.read_meta("last")
            resumable = bool(meta and meta.get("full")) and \
                checkpoint.has_full("last")
            if resumable and resume_token is not None:
                # a changed training config (a fine-tune stage into the
                # same save_dir) starts fresh; a tokenless sidecar resumes
                stored = meta.get("config")
                if stored is not None and stored != resume_token:
                    resumable = False
                    print("Exact resume: existing 'last' checkpoint was "
                          "saved by a DIFFERENT training config; starting "
                          "this stage fresh", flush=True)
            if resumable:
                self.step, meta = checkpoint.restore_full(
                    self.model, self.optimizer, "last", ema=self.ema)
                start_epoch = int(meta.get("epoch", 0))
                self.history = {k: list(v) for k, v in
                                meta.get("history", {}).items()}
                lr_scale = float(meta.get("lr_scale", 1.0))
                for key, cb in named_cbs.items():
                    if cb is not None and key in meta.get("callbacks", {}):
                        cb.load_state_dict(meta["callbacks"][key])
                if meta.get("stopped"):
                    start_epoch = epochs  # the run had early-stopped
                if hasattr(train_data, "set_epoch"):
                    train_data.set_epoch(start_epoch)
                if verbose:
                    print(f"Exact resume: continuing from epoch "
                          f"{start_epoch}", flush=True)
            else:
                save_last(0)

        def preempted(where: str) -> None:
            self.preempted = True
            if verbose:
                print(f"Preemption signal {where}: 'last' holds the state "
                      f"epoch {epoch} started from; exiting", flush=True)

        try:
            for epoch in range(start_epoch, epochs):
                t0 = time.time()
                if sched is not None:
                    set_learning_rate(self.optimizer,
                                      sched.on_epoch_begin(epoch) * lr_scale)
                prof = None
                if profile_dir is not None and epoch == profile_epoch:
                    prof = _profiler(self.device)
                    prof.__enter__()
                # -------- train epoch --------
                mstates = self._metric_init()
                losses = []
                for x, y in train_data():
                    loss, mstates = self.train_step(*self._batch(x, y),
                                                    mstates, step=self.step)
                    self.step += 1
                    losses.append(loss)
                    if watch is not None and watch.triggered:
                        break  # preemption: stop at a step boundary
                if prof is not None:
                    _synchronize(self.device)
                    prof.__exit__(None, None, None)
                    os.makedirs(profile_dir, exist_ok=True)
                    prof.export_chrome_trace(os.path.join(profile_dir,
                                                          "trace.json"))
                if watch is not None and watch.triggered:
                    preempted(f"in epoch {epoch} (step {len(losses)})")
                    break
                logs: tp.Dict[str, float] = {}
                if losses:
                    logs["loss"] = float(torch.stack(losses).mean())
                    logs["steps_per_sec"] = len(losses) / max(
                        time.time() - t0, 1e-9)
                logs.update(self._metric_results(mstates))
                # -------- validation epoch --------
                if val_data is not None:
                    vstates = self._metric_init()
                    vlosses = []
                    for x, y in val_data():
                        if watch is not None and watch.triggered:
                            break  # preemption: abandon the partial pass
                        vloss, _, vstates = self.eval_step(
                            *self._batch(x, y), vstates)
                        vlosses.append(vloss)
                    if vlosses:
                        logs["val_loss"] = float(torch.stack(vlosses).mean())
                    logs.update(self._metric_results(vstates, "val_"))
                if watch is not None and watch.triggered:
                    # this epoch's logs never reach the history; the
                    # resumed run trains the epoch again (JAX :377-390)
                    preempted("during validation")
                    break
                logs["lr"] = get_learning_rate(self.optimizer)
                logs["epoch_time"] = time.time() - t0
                for k, v in logs.items():
                    self.history.setdefault(k, []).append(v)
                if tb is not None:
                    for k, v in logs.items():
                        tb.add_scalar(k, v, global_step=epoch)
                    tb.flush()
                if verbose:
                    msg = " - ".join(f"{k}: {v:.5g}" for k, v in logs.items())
                    print(f"Epoch {epoch + 1}/{epochs} [{len(losses)} steps] "
                          f"{msg}", flush=True)
                # -------- callbacks --------
                if guard is not None and guard.check(logs):
                    if not guard.on_failure():
                        print("NaNGuard: abort after repeated non-finite "
                              "loss", flush=True)
                        break
                    if checkpoint is not None and checkpoint.exists("best"):
                        checkpoint.restore(self.model, None, "best",
                                           ema=self.ema)
                        recovery = "restored best"
                    else:
                        self._reinitialize(epoch)
                        recovery = "re-initialized params"
                    lr_scale *= guard.lr_factor
                    new_lr = logs["lr"] * guard.lr_factor
                    set_learning_rate(self.optimizer, new_lr)
                    if verbose:
                        print(f"NaNGuard: non-finite loss; {recovery} and "
                              f"reduced lr to {new_lr:.3g}", flush=True)
                    save_last(epoch + 1)
                    if watch is not None and watch.triggered:
                        self.preempted = True
                        break
                    continue
                if best is not None and best.is_best(logs):
                    checkpoint.save(self.model, self.optimizer, "best",
                                    ema=self.ema)
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
                        save_last(epoch + 1, stopped=True)
                        break
                save_last(epoch + 1)
                if watch is not None and watch.triggered:
                    # the epoch is complete and saved: exit now
                    if verbose:
                        print(f"Preemption signal: epoch {epoch + 1} "
                              "complete and saved; exiting", flush=True)
                    self.preempted = True
                    break
        finally:
            if watch is not None:
                watch.restore()
            if tb is not None:
                tb.close()
        return self.history

    def evaluate(self, data: BatchIter) -> tp.Dict[str, float]:
        """The eval-mode loss (mean over the batches) and metrics of
        ``data``, on the EMA shadow when there is one."""
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
        """Every head of the eval-mode forward of the NHWC batch ``x`` (a
        (B, L, C) batch for a 1D model) on the trainer's device (on the
        EMA shadow when there is one), as float32 numpy arrays.  ``tta``
        names views (eval.tta.TTA_2D, TTA_1D by the batch's rank) to
        average over; all views of the batch run as one forward."""
        step = make_tta_fn(self.predict_step, tta, rank=np.ndim(x) - 2)
        with torch.inference_mode():
            out = step(self.to_device(x))
            return {k: v.float().cpu().numpy() for k, v in out.items()}


def _profiler(device: torch.device):
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=activities)


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
