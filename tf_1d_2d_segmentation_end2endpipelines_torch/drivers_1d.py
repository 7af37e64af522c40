"""The port's 1D signal verbs (JAX: tf_1d_2d_segmentation_
end2endpipelines_tpu/drivers_1d.py): ``train_1d`` (:152), ``test_1d``
(:316) and ``predict_1d`` (:281), configured by a Signal_Configs.ini
(section ``[SIGNAL1D]``), with the model building (``_build_model_1d``,
:51), the deep-supervision targets (``_wrap_targets_1d``, :65) and the
weight restore (``_restore_model_1d``, the counterpart of
``_restore_trainer_1d``, :74).

Artifacts under ``save_dir``, as the JAX verbs write them: the config as
trained (``Signal_Configs.ini``), ``best.pt`` (the weights of the best
epoch; JAX writes an orbax ``best`` directory), ``best_ema.pt`` with
``ema_decay``, ``last.pt`` and its sidecar with ``exact_resume``,
``history.json`` (and ``history.png`` where matplotlib imports) and
``test_metrics_1d.json``; ``predict_1d`` writes an ``.npz``.

Every verb runs on the GPU (``device="cuda"``) unless asked for the CPU,
and never falls back to it.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import os
import typing as tp

import numpy as np
import torch

from . import eval as ev
from .data import (batches, load_signal_dataset, load_signal_inputs,
                   prepare_train_dict)
from .drivers import (_check_step_keys, _resolve_dtype, _restore_model,
                      _save_history, resolve_device)
from .models import model_selector_1d
from .models.api_1d import check_pools_1d
from .train import (CheckpointManager, EarlyStopping, ReduceLROnPlateau,
                    Trainer, default_ds_weights)
from .utils.config import (Signal1DConfig, load_signal_config, resume_token,
                           save_signal_config, unported_signal_keys)


def _build_model_1d(cfg: Signal1DConfig,
                    dtype: tp.Optional[torch.dtype] = None,
                    generator: tp.Optional[torch.Generator] = None
                    ) -> torch.nn.Module:
    return model_selector_1d(
        cfg.model_name, cfg.signal_length, cfg.model_depth,
        cfg.num_channel, cfg.model_width, cfg.kernel_size,
        problem_type=cfg.problem_type, output_nums=cfg.output_nums,
        ds=cfg.d_s, ae=cfg.a_e, ag=cfg.a_g, lstm=cfg.lstm,
        alpha=cfg.alpha, q=cfg.q_onn, dense_loop=cfg.dense_loop,
        feature_number=cfg.feature_number, is_transconv=cfg.is_transconv,
        cardinality=cfg.cardinality, pooling_type=cfg.pooling_type,
        se_ratio=cfg.se_ratio, block_size=cfg.block_size,
        t=cfg.t, keep_prob=cfg.keep_prob,
        dtype=_resolve_dtype(cfg, dtype), generator=generator)


def _wrap_targets_1d(cfg: Signal1DConfig
                     ) -> tp.Optional[tp.Callable[[torch.Tensor], tp.Dict]]:
    """The trainer's ``prepare_targets`` for ``cfg``: with ``d_s = 1``
    the (B, L, 1) mask batch becomes its deep-supervision targets on the
    device, after the copy (ds_type ``UNet``: one 1D pyramid launch for
    every level); None without."""
    if cfg.d_s != 1:
        return None
    return functools.partial(prepare_train_dict, model_depth=cfg.model_depth,
                             ds_type=cfg.ds_type, spatial_rank=1)


def _check_model_1d(cfg: Signal1DConfig, verb: str) -> None:
    bad = unported_signal_keys(cfg)
    if bad:
        raise NotImplementedError(
            f"the port's {verb} verb does not take these settings yet: "
            + ", ".join(bad))


def _check_signal_config(cfg: Signal1DConfig) -> None:
    """Raise before ``train_1d`` writes anything: ``NotImplementedError``
    for a key the port does not take (``unported_signal_keys``) and for a
    model or deep-supervision targets that pool by more than the port's
    1D kernels take (``check_pools_1d``), ``ValueError`` for ``remat =
    blocks`` (the JAX verb's message) and the settings the 2D verb
    refuses, ``ImportError`` naming a host package a setting needs.  An
    unknown ``model_name`` raises the JAX package's ``ValueError`` when
    the model is built, before the first write."""
    _check_model_1d(cfg, "train1d")
    check_pools_1d(cfg.model_name, cfg.model_depth,
                   ds_targets=cfg.d_s == 1 and cfg.ds_type != "UNetPP")
    if cfg.remat == "blocks":
        raise ValueError(
            "remat = blocks is 2D-only (SegModel block_remat); for 1D use "
            "remat = conv_outs, which saves the same set of conv outputs "
            "via a whole-step jax.checkpoint")
    _check_step_keys(cfg, 2, ((bool(cfg.tensorboard_dir), "tensorboard",
                               "tensorboard (tensorboard_dir)"),))


def _restore_model_1d(cfg: Signal1DConfig, action: str,
                      device: tp.Union[str, torch.device],
                      dtype: tp.Optional[torch.dtype] = None,
                      seed: tp.Optional[int] = None
                      ) -> tp.Tuple[torch.nn.Module, bool]:
    """The model of ``cfg`` on ``device`` in eval mode with ``<save_dir>/
    best.pt`` (and its EMA shadow) over weights drawn from ``seed``
    (default: the INI seed); a WARNING when there is no ``best.pt``.
    Returns (model, restored)."""
    _check_model_1d(cfg, "1D")
    ckpt_dir = cfg.save_dir or "."
    restored = CheckpointManager(ckpt_dir).exists("best")
    model = _restore_model(cfg, ckpt_dir, action, device, dtype=dtype,
                           seed=seed, build=_build_model_1d)
    return model, restored


def _load_config(config_path: str, config: tp.Optional[Signal1DConfig],
                 seed: tp.Optional[int]) -> Signal1DConfig:
    cfg = config if config is not None else load_signal_config(config_path)
    return cfg if seed is None else dataclasses.replace(cfg, seed=seed)


def train_1d(config_path: str = "Signal_Configs.ini",
             config: tp.Optional[Signal1DConfig] = None,
             dtype: tp.Optional[torch.dtype] = None,
             device: tp.Union[str, torch.device] = "cuda",
             seed: tp.Optional[int] = None,
             verbose: int = 1) -> tp.Dict[str, tp.List[float]]:
    """Train on a .pt signal set (JAX ``train_1d``; notebook cells 35-49).
    Returns the history and writes, under ``save_dir``, the config as
    trained, ``best.pt`` (and ``best_ema.pt``, ``last.pt``), and with
    ``save_history`` ``history.json`` (``history.png`` where matplotlib
    imports, else one line saying it was not drawn).  The trainer takes
    accumulation, remat (not ``blocks``), EMA, the clips, TensorBoard and
    exact resume from the INI; with ``d_s = 1`` the targets are built on
    the device (``_wrap_targets_1d``) and the heads weighted by
    ``default_ds_weights``.  Batches keep the partial last one, as JAX's
    do, but under accumulation, where a partial batch would not split.

    ``device`` defaults to the GPU and never falls back to the CPU;
    ``seed`` replaces the INI ``seed`` (weights and shuffle)."""
    cfg = _load_config(config_path, config, seed)
    device = resolve_device(device)
    _check_signal_config(cfg)
    model = _build_model_1d(cfg, dtype=dtype,
                            generator=torch.Generator().manual_seed(cfg.seed))
    if cfg.save_dir:
        os.makedirs(cfg.save_dir, exist_ok=True)
        save_signal_config(cfg, os.path.join(cfg.save_dir,
                                             "Signal_Configs.ini"))
    x, y = load_signal_dataset(cfg.train_set, cfg.x_key, cfg.y_key)
    if len(x) == 0:
        raise ValueError(f"empty training set {cfg.train_set!r}")
    val_data = None
    if cfg.val_set:
        if os.path.exists(cfg.val_set):
            xv, yv = load_signal_dataset(cfg.val_set, cfg.x_key, cfg.y_key)
            val_data = batches(xv, yv, cfg.batch_size, shuffle=False,
                               drop_remainder=False)
        else:
            print(f"WARNING: val_set {cfg.val_set!r} does not exist; "
                  "training without validation (monitor falls back to "
                  "train loss)", flush=True)
    remat = cfg.remat.strip()
    trainer = Trainer(
        model, loss=cfg.loss_function, optimizer=cfg.optimizer_function,
        learning_rate=cfg.learning_rate, metrics=tuple(cfg.metric_list),
        loss_weights=(default_ds_weights(cfg.model_depth)
                      if cfg.d_s == 1 else None),
        device=device, clipnorm=cfg.clipnorm, clipvalue=cfg.clipvalue,
        global_clipnorm=cfg.global_clipnorm,
        prepare_targets=_wrap_targets_1d(cfg), seed=cfg.seed,
        remat=remat or None, accum_steps=cfg.accumulation_steps,
        ema_decay=cfg.ema_decay)
    ckpt = CheckpointManager(cfg.save_dir) if cfg.save_dir else None
    if ckpt is not None and cfg.load_weights and ckpt.exists("best"):
        ckpt.restore(trainer.model, trainer.optimizer, "best",
                     ema=trainer.ema)
        print(f"resumed from {ckpt.path('best')}", flush=True)
    monitor = cfg.monitor_param
    if monitor.startswith("val_") and val_data is None:
        monitor = monitor[len("val_"):] or "loss"
    history = trainer.fit(
        batches(x, y, cfg.batch_size, shuffle=True, seed=cfg.seed,
                drop_remainder=cfg.accumulation_steps > 1),
        val_data=val_data, epochs=cfg.num_epochs,
        callbacks=[
            EarlyStopping(monitor=monitor, patience=cfg.patience_amount,
                          mode=cfg.patience_mode),
            ReduceLROnPlateau(monitor=monitor, factor=cfg.rlronp_factor,
                              patience=cfg.patience_amount_rlronp,
                              mode=cfg.patience_mode),
        ],
        checkpoint=ckpt, monitor=monitor, verbose=verbose,
        tensorboard_dir=cfg.tensorboard_dir or None,
        exact_resume=cfg.exact_resume, resume_token=resume_token(cfg))
    if cfg.save_history and cfg.save_dir:
        _save_history(history, cfg.save_dir,
                      cfg.metric_list[0] if cfg.metric_list else None,
                      h5=False)
    return history


def _predict_all(trainer: Trainer, x: np.ndarray, batch_size: int,
                 tta: tp.Sequence[str]) -> tp.Dict[str, np.ndarray]:
    """Every head of ``x``'s prediction, in batches of ``batch_size``."""
    chunks: tp.Dict[str, tp.List[np.ndarray]] = {}
    for start in range(0, len(x), max(batch_size, 1)):
        out = trainer.predict(x[start:start + batch_size], tta)
        for k, v in out.items():
            chunks.setdefault(k, []).append(v)
    return {k: np.concatenate(v) for k, v in chunks.items()}


def predict_1d(config_path: str = "Signal_Configs.ini",
               config: tp.Optional[Signal1DConfig] = None,
               input_path: tp.Optional[str] = None,
               out_path: str = "predictions_1d.npz",
               dtype: tp.Optional[torch.dtype] = None,
               device: tp.Union[str, torch.device] = "cuda",
               seed: tp.Optional[int] = None) -> str:
    """Inference on unlabeled signals (JAX ``predict_1d``): the .pt at
    ``input_path`` (default: the config's ``test_set``; labels, if
    present, are ignored) through the fold's ``best.pt`` (a WARNING and
    weights from ``seed`` when absent), in batches of ``batch_size``
    averaged over the ``tta`` views; writes ``out_path``, an ``.npz`` with
    ``output`` and any DS heads (``level<k>``).  Returns ``out_path``.
    ``device`` defaults to the GPU and never falls back to the CPU."""
    cfg = _load_config(config_path, config, seed)
    device = resolve_device(device)
    path = input_path or cfg.test_set
    x = load_signal_inputs(path, cfg.x_key)
    if len(x) == 0:
        raise ValueError(f"empty input set {path!r}")
    model, _ = _restore_model_1d(cfg, "predicting with", device, dtype=dtype)
    trainer = Trainer(model, device=device)
    outs = _predict_all(trainer, x, cfg.batch_size,
                        ev.parse_tta(cfg.tta, rank=1))
    np.savez(out_path, **{("output" if k == "out" else k): v
                          for k, v in outs.items()})
    print(f"wrote {len(x)} predictions to {out_path}", flush=True)
    return out_path


def test_1d(config_path: str = "Signal_Configs.ini",
            config: tp.Optional[Signal1DConfig] = None,
            dtype: tp.Optional[torch.dtype] = None,
            device: tp.Union[str, torch.device] = "cuda",
            seed: tp.Optional[int] = None) -> tp.Dict[str, tp.Any]:
    """Evaluate on the config's ``test_set`` with the notebook's NILM
    metric suite (JAX ``test_1d``; cells 51-63): MAE, MSE, RMSE, PCC, SAE
    and EA (over the windows with positive ground energy; None when there
    is none), JEOI, DEOI and ``restored_checkpoint``.  Predictions as
    ``predict_1d`` makes them.  Prints each and writes ``<save_dir>/
    test_metrics_1d.json``; returns the dict.  ``device`` defaults to the
    GPU and never falls back to the CPU."""
    cfg = _load_config(config_path, config, seed)
    device = resolve_device(device)
    x, y = load_signal_dataset(cfg.test_set, cfg.x_key, cfg.y_key)
    model, restored = _restore_model_1d(cfg, "evaluating", device,
                                        dtype=dtype)
    trainer = Trainer(model, device=device)
    pred = _predict_all(trainer, x, cfg.batch_size,
                        ev.parse_tta(cfg.tta, rank=1))["out"]
    metrics: tp.Dict[str, tp.Any] = dict(ev.construction_error(y, pred))
    # SAE and EA divide by the ground energy (per window for EA): only
    # the windows with positive energy, as the JAX verb
    pos = y.reshape(len(y), -1).sum(axis=1) > 0
    if pos.any():
        metrics["SAE"] = ev.calculate_sae(y[pos], pred[pos])
        metrics["EA"] = ev.calculate_ea(y[pos], pred[pos])
    else:
        metrics["SAE"] = metrics["EA"] = None
    metrics["JEOI"] = ev.calculate_jeoi(y, pred)
    metrics["DEOI"] = ev.calculate_deoi(y, pred)
    metrics["restored_checkpoint"] = bool(restored)
    for k, v in metrics.items():
        print(f"{k}: {v}", flush=True)
    if cfg.save_dir:
        os.makedirs(cfg.save_dir, exist_ok=True)
        with open(os.path.join(cfg.save_dir, "test_metrics_1d.json"),
                  "w") as f:
            json.dump(metrics, f)
    return metrics
