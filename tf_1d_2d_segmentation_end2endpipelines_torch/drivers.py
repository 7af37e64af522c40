"""The port's verbs: the ``train`` and ``test`` fold loops, ``predict``
on unlabeled images, and the model building and weight restore that
``serve`` uses (JAX: tf_1d_2d_segmentation_end2endpipelines_tpu/
drivers.py:54-138, ``train`` :197-403, ``test`` :406-570 and ``predict``
:741-827).

Weights live in ``<save_dir>/Fold_<fold>/best.pt``: a ``state_dict`` of the
port's model, which ``train`` writes and ``serve`` and ``test`` load
(``utils/flax_to_torch.py`` makes one from a flax tree).
"""
from __future__ import annotations

import dataclasses
import functools
import json
import os
import time
import typing as tp

import numpy as np
import torch

from . import eval as ev
from .data import (DS_TYPES, PrefetchLoader, SegmentationFolderDataset,
                   prepare_train_dict, split_dataset)
from .data.patch import create_patches, unpatchify
from .models import model_selector
from .ops.remat import check_policy
from .train import (CheckpointManager, EarlyStopping, ReduceLROnPlateau,
                    Trainer, default_ds_weights, get_loss, make_metric,
                    make_optimizer)
from .train.checkpoint import weights_file
from .utils.config import (TestConfig, TrainConfig, load_test_config,
                           load_train_config, resume_token,
                           save_train_config, unported_train_keys)

#: file name of a fold's serving weights under its checkpoint directory
BEST_WEIGHTS = weights_file("best")


def _resolve_dtype(cfg: TrainConfig, dtype: tp.Optional[torch.dtype]
                   ) -> torch.dtype:
    """``dtype=None`` means "use the INI ``compute_dtype``"; an explicit
    dtype always wins."""
    if dtype is not None:
        return dtype
    name = getattr(cfg, "compute_dtype", "float32").strip().lower()
    if name in ("", "float32", "f32"):
        return torch.float32
    if name in ("bfloat16", "bf16"):
        return torch.bfloat16
    raise ValueError(f"unknown compute_dtype {name!r} "
                     "(expected float32 or bfloat16)")


def _build_model(cfg: TrainConfig, dtype: tp.Optional[torch.dtype] = None,
                 generator: tp.Optional[torch.Generator] = None):
    return model_selector(
        model_genre=cfg.model_genre,
        encoder_name=cfg.encoder_name,
        decoder_name=cfg.decoder_name,
        # the size the model sees: a patch under patchify (JAX sizes the
        # autoencoder bottleneck from its init batch:
        # tf_1d_2d_segmentation_end2endpipelines_tpu/drivers.py:337-341)
        length=cfg.patch_width if cfg.patchify else cfg.imlength,
        width=cfg.patch_height if cfg.patchify else cfg.imwidth,
        model_width=cfg.model_width,
        model_depth=cfg.model_depth,
        num_channels=cfg.num_channels,
        output_nums=cfg.output_nums,
        ds=cfg.d_s, ae=cfg.a_e, ag=cfg.a_g, lstm=cfg.lstm,
        dense_loop=cfg.dense_loop,
        is_transconv=cfg.is_transconv,
        alpha=cfg.alpha, q=cfg.q_onn,
        feature_number=cfg.feature_number,
        final_activation=cfg.final_activation,
        train_mode=cfg.train_mode,
        is_base_model_trainable=cfg.encoder_trainable,
        dtype=_resolve_dtype(cfg, dtype),
        generator=generator,
        block_remat=cfg.remat == "blocks",
    )


def resolve_device(device: tp.Union[str, torch.device]) -> torch.device:
    """``torch.device(device)``, refusing a CUDA device this host lacks
    (nothing falls back to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {str(device)!r} requested but CUDA is "
                           "not available on this host")
    return device


def _restore_model(cfg: TrainConfig, ckpt_dir: str, action: str,
                   device: tp.Union[str, torch.device],
                   dtype: tp.Optional[torch.dtype] = None,
                   seed: tp.Optional[int] = None,
                   build: tp.Callable[..., torch.nn.Module] = _build_model
                   ) -> torch.nn.Module:
    """Build the model (``build(cfg, dtype=, generator=)``) with weights
    drawn from ``seed`` (default: the INI ``seed``), load ``<ckpt_dir>/
    best.pt`` over them when it exists (warn when absent) and, when the
    fold kept an EMA shadow (``best_ema.pt``, saved with this
    ``best.pt``), the shadow over the parameters: the weights the run
    validated on
    (JAX ``eval_params``, serve.py:53-54); move it to ``device`` and
    switch it to eval mode."""
    device = resolve_device(device)
    gen = torch.Generator().manual_seed(cfg.seed if seed is None else seed)
    model = build(cfg, dtype=dtype, generator=gen)
    ckpt = CheckpointManager(ckpt_dir)
    if ckpt.exists("best"):
        shadow = ckpt.restore(model, None, "best")
        if shadow is not None:
            model.load_state_dict(shadow, strict=False)
    else:
        print(f"WARNING: no 'best' checkpoint under {ckpt_dir}; "
              f"{action} freshly initialized weights", flush=True)
    return model.to(device).eval()


def _fold_dir(cfg: TrainConfig, fold: int) -> str:
    return os.path.join(cfg.save_dir or "", f"Fold_{fold}")


def _fold_data_dir(directory: str, fold: int) -> str:
    """``<directory>/fold_<k>`` when it exists, else ``directory``."""
    sub = os.path.join(directory, f"fold_{fold}")
    return sub if os.path.isdir(sub) else directory


def _check_train_config(cfg: TrainConfig) -> None:
    """Raise before the verb writes anything: ``NotImplementedError`` for
    whatever setting of ``cfg`` the port cannot train yet, ``ValueError``
    for settings that do not go together (the JAX verb's guards,
    drivers.py:207-220 and :309-313) or an unknown name, ``ImportError``
    naming the host package a setting needs (the verb builds its first
    model before writing, so an unported architecture raises there)."""
    bad = unported_train_keys(cfg)
    if bad:
        hint = ("; ImageNet and .h5 encoder weights are not in the "
                "repository: set encoder_weights = none to train the "
                "encoder from random weights"
                if any(b.startswith("encoder_weights") for b in bad) else "")
        raise NotImplementedError(
            "the port's train verb does not take these settings yet: "
            + ", ".join(bad) + hint)
    if cfg.augment_device and cfg.patchify:
        # the host path augments the whole image before patchify; patches
        # of one image augmented apart would not be that
        raise ValueError(
            "augment_device does not compose with patchify (patches of one "
            "image would augment independently); use the host path: "
            "augment = 1")
    if cfg.augment_device and cfg.augment:
        raise ValueError(
            "augment and augment_device are alternatives (the same op set "
            "on the host or on the card); both would augment every sample "
            "twice: pick one")
    _check_step_keys(cfg, _num_classes(cfg), (
        (cfg.augment, "cv2", "opencv-python (augment = 1)"),
        (bool(cfg.tensorboard_dir), "tensorboard",
         "tensorboard (tensorboard_dir)")))


def _check_step_keys(cfg, num_classes: int,
                     packages: tp.Sequence[tp.Tuple[bool, str, str]]
                     ) -> None:
    """The checks the 2D and 1D train verbs share, on ``cfg`` (a
    ``TrainConfig`` or ``Signal1DConfig``): accumulation, remat (but
    ``blocks``, which each verb judges), EMA decay, the host packages
    (``(needed, module, what)``), ds_type and the loss, metric and
    optimizer names."""
    if cfg.accumulation_steps < 1 or (
            cfg.accumulation_steps > 1
            and cfg.batch_size % cfg.accumulation_steps):
        raise ValueError(
            f"batch_size={cfg.batch_size} must be divisible by "
            f"accumulation_steps={cfg.accumulation_steps}")
    if cfg.remat != "blocks":
        check_policy(cfg.remat.strip() or None)
    if not 0.0 <= cfg.ema_decay < 1.0:
        raise ValueError(f"ema_decay must be in [0, 1), got {cfg.ema_decay}")
    for needed, module, package in packages:
        if needed:
            try:
                __import__(module)
            except ImportError as e:
                raise ImportError(f"the train verb needs {package}, which "
                                  "this host does not have") from e
    if cfg.d_s and cfg.ds_type not in DS_TYPES:
        raise ValueError(f"Unknown ds_type {cfg.ds_type!r}")
    get_loss(cfg.loss_function)
    for name in cfg.metric_list:
        make_metric(name, num_classes=num_classes)
    make_optimizer(cfg.optimizer_function,
                   [torch.zeros(1, requires_grad=True)], cfg.learning_rate)


def _num_classes(cfg: TrainConfig) -> int:
    """The IoU metrics' size: the background and ``class_number`` classes,
    at least 2 (JAX drivers.py:324)."""
    return max(cfg.class_number + 1, 2)


def _make_trainer(cfg: TrainConfig, model: torch.nn.Module,
                  device: tp.Union[str, torch.device]) -> Trainer:
    """The verb's ``Trainer`` for ``cfg``.  With ``d_s = 1`` each mask
    batch becomes its deep-supervision targets on the device, after the
    copy (the JAX driver's ``_wrap_targets``, drivers.py:183; one pyramid
    launch for ds_type ``UNet``), and the heads' losses are weighted by
    ``default_ds_weights`` (:314-315).  The metrics are sized by
    ``class_number``, the gradients clipped as the INI says, and the step
    takes ``remat`` (``blocks`` remats inside the model, so the step runs
    plain), ``accumulation_steps`` and ``ema_decay`` (:317-337)."""
    ds = cfg.d_s == 1
    remat = cfg.remat.strip()
    return Trainer(
        model, loss=cfg.loss_function, optimizer=cfg.optimizer_function,
        learning_rate=cfg.learning_rate, metrics=tuple(cfg.metric_list),
        loss_weights=default_ds_weights(cfg.model_depth) if ds else None,
        num_classes=_num_classes(cfg), device=device,
        clipnorm=cfg.clipnorm, clipvalue=cfg.clipvalue,
        global_clipnorm=cfg.global_clipnorm,
        prepare_targets=functools.partial(
            prepare_train_dict, model_depth=cfg.model_depth,
            ds_type=cfg.ds_type) if ds else None,
        seed=cfg.seed, remat=remat if remat != "blocks" else None,
        accum_steps=cfg.accumulation_steps, ema_decay=cfg.ema_decay)


def train(config_path: str = "Train_Configs.ini",
          config: tp.Optional[TrainConfig] = None,
          dtype: tp.Optional[torch.dtype] = None,
          device: tp.Union[str, torch.device] = "cuda",
          seed: tp.Optional[int] = None,
          verbose: int = 1) -> tp.Dict[int, tp.Dict[str, tp.List[float]]]:
    """Fold-loop training driver (reference Train.py).  Returns
    ``{fold: history}`` and writes, under ``save_dir``, the config as
    trained (``Train_Configs.ini``) and per fold ``Fold_<k>/best.pt`` (the
    weights of the best epoch by ``monitor_param``), its optimizer state,
    its EMA shadow (``best_ema.pt``, with ``ema_decay``), ``last.pt`` and
    its sidecar (with ``exact_resume``), and with ``save_history``
    ``history.json``, ``history.h5`` (where h5py imports) and
    ``history.png`` (where matplotlib imports; else one line says it was
    not drawn).  ``augment`` augments on the host, ``augment_device`` on
    the device keyed by (seed, epoch, step); ``patchify`` trains and
    validates on patches; ``tensorboard_dir`` writes the scalars under
    ``<tensorboard_dir>/Fold_<k>``.  After a SIGTERM under
    ``exact_resume`` the fold loop stops; the same config run again
    resumes (JAX drivers.py:197-403).

    ``device`` defaults to the GPU and never falls back to the CPU;
    ``seed`` replaces the INI ``seed`` (weights, shuffle, split,
    augmentation)."""
    cfg = config if config is not None else load_train_config(config_path)
    if seed is not None:
        cfg = dataclasses.replace(cfg, seed=seed)
    device = resolve_device(device)
    _check_train_config(cfg)

    def build() -> torch.nn.Module:
        return _build_model(cfg, dtype=dtype,
                            generator=torch.Generator().manual_seed(cfg.seed))

    first_model = build()  # an unported architecture raises here
    if cfg.save_dir:
        os.makedirs(cfg.save_dir, exist_ok=True)
        save_train_config(cfg, os.path.join(cfg.save_dir,
                                            "Train_Configs.ini"))
    size = (cfg.imlength, cfg.imwidth)
    dev_aug = None
    if cfg.augment_device:
        from .data.device_augment import make_device_augment
        # raw 0-255 inputs keep their range (JAX :229-237)
        dev_aug = make_device_augment(
            value_range=255.0 / cfg.normalizing_factor_img)
    patches = dict(patchify=cfg.patchify,
                   patch_shape=(cfg.patch_width, cfg.patch_height),
                   overlap_ratio=cfg.overlap_ratio, cache=cfg.cache_data)

    def dataset(directory: str, fold: int) -> SegmentationFolderDataset:
        return SegmentationFolderDataset(
            _fold_data_dir(directory, fold), size, cfg.image_color_mode,
            cfg.mask_color_mode, cfg.normalizing_factor_img,
            cfg.normalizing_factor_msk)

    histories: tp.Dict[int, tp.Dict[str, tp.List[float]]] = {}
    for fold in range(cfg.start_fold, cfg.end_fold + 1):
        model = first_model if fold == cfg.start_fold else build()
        train_ds = dataset(cfg.train_dir, fold)
        split_val_ds = None
        if not cfg.independent_val_set and cfg.validation_portion > 0:
            train_ds, split_val_ds = split_dataset(
                train_ds, cfg.validation_portion, seed=cfg.seed)
        # accumulation splits each batch into microbatches: a partial last
        # batch would not divide, so it is dropped (train loader only)
        loader = PrefetchLoader(train_ds, cfg.batch_size, shuffle=True,
                                seed=cfg.seed, augment=cfg.augment,
                                drop_remainder=cfg.accumulation_steps > 1,
                                **patches)
        val_loader = None
        if split_val_ds is not None and len(split_val_ds):
            val_loader = PrefetchLoader(split_val_ds, cfg.batch_size,
                                        shuffle=False, **patches)
        elif cfg.independent_val_set and os.path.isdir(cfg.val_dir):
            val_loader = PrefetchLoader(dataset(cfg.val_dir, fold),
                                        cfg.batch_size, shuffle=False,
                                        **patches)
        trainer = _make_trainer(cfg, model, device)
        train_iter = _train_batches(loader, dev_aug, cfg.seed, trainer)
        ckpt_dir = _fold_dir(cfg, fold)
        ckpt = CheckpointManager(ckpt_dir)
        if cfg.load_weights and ckpt.exists("best"):  # Train.py:361-369
            ckpt.restore(trainer.model, trainer.optimizer, "best",
                         ema=trainer.ema)
            print(f"Fold {fold}: resumed from {ckpt.path('best')}",
                  flush=True)
        monitor = cfg.monitor_param
        if monitor.startswith("val_") and val_loader is None:
            monitor = monitor[len("val_"):] or "loss"
        history = trainer.fit(
            train_iter, val_data=val_loader, epochs=cfg.num_epochs,
            callbacks=[
                EarlyStopping(monitor=monitor, patience=cfg.patience_amount,
                              mode=cfg.patience_mode),
                ReduceLROnPlateau(monitor=monitor, factor=cfg.rlronp_factor,
                                  patience=cfg.patience_amount_rlronp,
                                  mode=cfg.patience_mode),
            ],
            checkpoint=ckpt, monitor=monitor, verbose=verbose,
            tensorboard_dir=(os.path.join(cfg.tensorboard_dir,
                                          f"Fold_{fold}")
                             if cfg.tensorboard_dir else None),
            exact_resume=cfg.exact_resume, resume_token=resume_token(cfg))
        histories[fold] = history
        if cfg.save_history:
            _save_history(history, ckpt_dir,
                          cfg.metric_list[0] if cfg.metric_list else None)
        if trainer.preempted:
            # the interrupted fold is resumable; another fold would spend
            # the grace window on work that cannot be saved
            print(f"Preemption: stopping after fold {fold}; re-run the "
                  "same config to resume", flush=True)
            break
    return histories


def _train_batches(loader: PrefetchLoader, dev_aug, seed: int,
                   trainer: Trainer):
    """The train loader as the trainer's batch source: with the on-card
    augment, each batch goes to the device and is augmented there under
    the stream keyed by (seed, epoch, step), the epoch read from the
    loader's counter before the epoch's first batch, as the JAX verb
    reads it (drivers.py:293-307).  ``set_epoch`` is the loader's, for
    exact resume."""
    if dev_aug is None:
        return loader
    from .data.device_augment import augment_stream_key

    def batches():
        epoch = loader._epoch
        for i, (x, y) in enumerate(loader()):
            yield dev_aug(augment_stream_key(seed, epoch, i),
                          trainer.to_device(x), trainer.to_device(y))

    batches.set_epoch = loader.set_epoch
    return batches


def _save_history(history: tp.Dict[str, tp.List[float]], ckpt_dir: str,
                  metric: tp.Optional[str], h5: bool = True) -> None:
    """``history.json``; with ``h5``, ``history.h5``, one dataset per key,
    the reference's format (Train.py:425-430), with a warning when it
    cannot be written; and ``history.png`` where matplotlib imports, else
    one line saying it was not drawn (JAX drivers.py:377-395)."""
    os.makedirs(ckpt_dir, exist_ok=True)
    with open(os.path.join(ckpt_dir, "history.json"), "w") as f:
        json.dump(history, f)
    try:
        if h5:
            import h5py
            with h5py.File(os.path.join(ckpt_dir, "history.h5"), "w") as hf:
                for k, v in history.items():
                    hf.create_dataset(k, data=np.asarray(v))
    except Exception as e:  # noqa: BLE001 (h5py absent, disk full, ...)
        print(f"WARNING: could not write history.h5 ({e})", flush=True)
    if ev.have_matplotlib():
        ev.plot_history(history, os.path.join(ckpt_dir, "history.png"),
                        metric_name=metric)
    else:
        print(f"{ckpt_dir}: matplotlib is not installed; figure not drawn: "
              "history.png", flush=True)


def _test_train_config(cfg: TestConfig) -> TrainConfig:
    """The architecture the ``test`` verb rebuilds: ``<save_dir>/
    Train_Configs.ini`` as ``train`` wrote it, with the TEST config's
    ``save_dir`` (where the folds are), else the TEST config's model keys
    (JAX drivers.py:413-429)."""
    saved = os.path.join(cfg.save_dir or ".", "Train_Configs.ini")
    if os.path.exists(saved):
        return dataclasses.replace(load_train_config(saved),
                                   save_dir=cfg.save_dir)
    return TrainConfig(
        imlength=cfg.imheight, imwidth=cfg.imwidth,
        num_channels=cfg.num_channels, encoder_mode=cfg.encoder_mode,
        encoder_name=cfg.encoder_name, decoder_name=cfg.decoder_name,
        d_s=cfg.d_s, output_nums=max(cfg.class_number, 1),
        save_dir=cfg.save_dir)


_FIGURES = ("confusion_matrix.png", "roc.png", "prc.png",
            "prediction_distributions.png", "sample_grid.png")


def test(config_path: str = "Test_Configs.ini",
         config: tp.Optional[TestConfig] = None,
         train_config: tp.Optional[TrainConfig] = None,
         device: tp.Union[str, torch.device] = "cuda",
         ) -> tp.Dict[tp.Union[int, str], tp.Dict[str, tp.Any]]:
    """Fold-loop evaluation (reference Test.py).  Per fold: the model of
    ``train_config`` (default: ``_test_train_config``) with the weights of
    ``Fold_<k>/best.pt`` (a WARNING and ``checkpoint_restored: False``
    when it is absent), predictions over ``<test_dir>/fold_<k>`` (or
    ``test_dir``) in batches padded to ``batch_size`` (patchify: all
    patches of an image in one batch), averaged over the ``tta`` views;
    label maps by ``label_from_pred``; the report's ``images_per_sec`` is
    the rate of that loop, PNG decode included; then, under ``<save_dir>/
    test_results/fold_<k>/``, ``masks/pred_<i>.png``, the results and
    confusion-matrix CSVs and, where matplotlib is installed, the figures
    (otherwise one line names those not drawn).  Returns ``{fold:
    report, "cumulative": report}`` (``eval.evaluation_table``).

    ``device`` defaults to the GPU and never falls back to the CPU."""
    from PIL import Image

    cfg = config if config is not None else load_test_config(config_path)
    tcfg = train_config if train_config is not None else _test_train_config(
        cfg)
    device = resolve_device(device)
    square = ((cfg.patch_width == cfg.patch_height) if cfg.patchify
              else (cfg.imheight == cfg.imwidth))
    tta = ev.parse_tta(cfg.tta, square=square)
    labels = list(cfg.labels) or [f"class_{i}"
                                  for i in range(cfg.class_number + 1)]
    n_classes = len(labels)
    draw = ev.have_matplotlib()
    reports: tp.Dict[tp.Union[int, str], tp.Dict[str, tp.Any]] = {}
    cm_total = ev.init_confusion_matrix(n_classes)
    for fold in range(cfg.start_fold, cfg.end_fold + 1):
        fold_dir = _fold_dir(tcfg, fold)
        restored = os.path.exists(os.path.join(fold_dir, BEST_WEIGHTS))
        # an unported architecture raises here, before anything is written
        model = _restore_model(tcfg, fold_dir, "evaluating", device)
        trainer = Trainer(model, device=device)
        ds = SegmentationFolderDataset(
            _fold_data_dir(cfg.test_dir, fold), (cfg.imheight, cfg.imwidth),
            cfg.image_color_mode, cfg.mask_color_mode,
            cfg.normalizing_factor_img, cfg.normalizing_factor_msk)
        results_dir = os.path.join(tcfg.save_dir or ".", "test_results",
                                   f"fold_{fold}")
        os.makedirs(os.path.join(results_dir, "masks"), exist_ok=True)

        def predictions() -> tp.Iterator[tp.Tuple[int, np.ndarray,
                                                  np.ndarray, np.ndarray]]:
            """(index, image, prediction, mask) per test image."""
            if cfg.patchify:
                for idx in range(len(ds)):
                    img, msk = ds.load_pair(idx)
                    patches, _ = create_patches(
                        img, (cfg.patch_width, cfg.patch_height),
                        cfg.overlap_ratio)
                    pred = unpatchify(trainer.predict(patches, tta)["out"],
                                      (cfg.imheight, cfg.imwidth),
                                      cfg.overlap_ratio)
                    yield idx, img, pred, msk
                return
            bs = max(cfg.batch_size, 1)
            for start in range(0, len(ds), bs):
                idxs = range(start, min(start + bs, len(ds)))
                pairs = [ds.load_pair(i) for i in idxs]
                batch = np.stack([p[0] for p in pairs])
                if len(pairs) < bs:  # one batch shape: cuDNN keeps its plans
                    batch = np.concatenate([batch, np.zeros(
                        (bs - len(pairs), *batch.shape[1:]), batch.dtype)])
                preds = trainer.predict(batch, tta)["out"]
                for k, i in enumerate(idxs):
                    yield i, pairs[k][0], preds[k], pairs[k][1]

        cm = ev.init_confusion_matrix(n_classes)
        y_true, y_pred, y_score, samples = [], [], [], []
        t0 = time.perf_counter()
        for idx, img, pred, msk in predictions():
            pred_lbl = ev.label_from_pred(pred, cfg.class_number,
                                          cfg.threshold)
            if cfg.class_number <= 1:
                true_lbl = (msk[..., 0] > cfg.threshold).astype(np.int32)
            else:
                true_lbl = msk[..., 0].astype(np.int32)
            cm = ev.confusion_matrix_update(
                cm, torch.from_numpy(true_lbl).to(device),
                torch.from_numpy(pred_lbl).to(device))
            y_true.append(true_lbl.ravel())
            y_pred.append(pred_lbl.ravel())
            if cfg.roc_from_scores:
                # foreground channels 0..class_number-1 score classes
                # 1..class_number; the background scores 1 - their max
                p = np.asarray(pred, np.float32).reshape(-1, pred.shape[-1])
                fg = p[:, :max(cfg.class_number, 1)]
                y_score.append(np.concatenate(
                    [1.0 - fg.max(axis=1, keepdims=True), fg], axis=1))
            if len(samples) < 4:
                samples.append((img, msk, pred_lbl))
            Image.fromarray((pred_lbl * (255 // max(n_classes - 1, 1))
                             ).astype(np.uint8)).save(
                os.path.join(results_dir, "masks", f"pred_{idx}.png"))
        loop_s = time.perf_counter() - t0
        cm_total += cm
        report = ev.evaluation_table(cm, labels)
        report["checkpoint_restored"] = restored
        report["images_per_sec"] = len(ds) / max(loop_s, 1e-9)
        reports[fold] = report
        ev.export_results_sheet(report,
                                os.path.join(results_dir, "results.xlsx"))
        if draw:
            yt, yp = np.concatenate(y_true), np.concatenate(y_pred)
            ys = np.concatenate(y_score) if y_score else None
            path = functools.partial(os.path.join, results_dir)
            ev.plot_conf_mat(cm, labels, path("confusion_matrix.png"))
            ev.plot_multiclass_roc(yt, yp, n_classes, path("roc.png"),
                                   y_score=ys)
            ev.plot_multiclass_precision_recall_curves(
                yt, yp, n_classes, path("prc.png"), y_score=ys)
            ev.plot_prediction_distributions(
                yt, yp, path("prediction_distributions.png"))
            if samples:
                ev.plot_sample_grid(*zip(*samples),
                                    path("sample_grid.png"))
        else:
            print(f"Fold {fold}: matplotlib is not installed; figures not "
                  f"drawn: {', '.join(_FIGURES)}", flush=True)
        print(f"Fold {fold}: overall accuracy "
              f"{report['overall_accuracy']:.2f}%; {len(ds)} images at "
              f"{report['images_per_sec']:.1f} img/s (decode included)",
              flush=True)
    reports["cumulative"] = ev.evaluation_table(cm_total, labels)
    return reports


def predict(config_path: tp.Union[str, TrainConfig] = "Train_Configs.ini",
            input_path: str = ".", out_dir: str = "predicted_masks",
            fold: int = 1, threshold: float = 0.5, batch: int = 8,
            tta: str = "", device: tp.Union[str, torch.device] = "cuda",
            seed: tp.Optional[int] = None) -> tp.List[str]:
    """Segment the unlabeled images under ``input_path`` (a file or a
    folder) with the fold's ``Fold_<fold>/best.pt`` (a WARNING and weights
    drawn from ``seed``, default the INI seed, when it is absent) and
    write ``<out_dir>/<stem>_mask.png`` label masks (``label_from_pred``
    at ``threshold``); returns their paths.  ``config_path`` is a
    Train_Configs.ini or a ``TrainConfig``.

    Without patchify the images run in padded chunks of ``min(batch,
    images)`` through a ``Predictor`` with the ``tta`` views (one forward
    a chunk), the next chunk decoded in a second thread while the card
    runs the current one; with patchify each image's patch grid runs
    through ``Trainer.predict`` and is reassembled by ``unpatchify``.
    ``ValueError`` for ``batch < 1``, ``FileNotFoundError`` when there is
    no image, ``NotImplementedError`` for an architecture the port does
    not build, all before anything is written.  ``device`` defaults to
    the GPU and never falls back to the CPU."""
    import concurrent.futures as cf

    from .data.generators import _list_images, load_image
    from .serve import Predictor

    if batch < 1:
        raise ValueError(f"batch must be >= 1, got {batch}")
    cfg = (load_train_config(config_path) if isinstance(config_path, str)
           else config_path)
    device = resolve_device(device)
    size = (cfg.imlength, cfg.imwidth)
    paths = ([input_path] if os.path.isfile(input_path)
             else _list_images(input_path))
    if not paths:
        raise FileNotFoundError(f"no images under {input_path!r}")
    square = ((cfg.patch_width == cfg.patch_height) if cfg.patchify
              else size[0] == size[1])
    views = ev.parse_tta(tta, square=square)
    model = _restore_model(cfg, _fold_dir(cfg, fold), "predicting with",
                           device, seed=seed)
    os.makedirs(out_dir, exist_ok=True)

    def decode(path: str) -> np.ndarray:
        return load_image(path, size, cfg.image_color_mode, "lanczos",
                          cfg.normalizing_factor_img)

    def write(pred: np.ndarray, src: str) -> str:
        return _write_mask(pred, src, out_dir, cfg.class_number, threshold)

    written = []
    if cfg.patchify:
        trainer = Trainer(model, device=device)
        for p in paths:
            patches, _ = create_patches(
                decode(p), (cfg.patch_width, cfg.patch_height),
                cfg.overlap_ratio)
            pred = unpatchify(trainer.predict(patches, views)["out"], size,
                              cfg.overlap_ratio)
            written.append(write(pred, p))
    else:
        predictor = Predictor(model, (*size, cfg.num_channels),
                              max_batch=min(batch, len(paths)), tta=views)
        chunks = [paths[s:s + predictor.max_batch]
                  for s in range(0, len(paths), predictor.max_batch)]

        def stack(chunk: tp.List[str]) -> np.ndarray:
            return np.stack([decode(p) for p in chunk])

        with cf.ThreadPoolExecutor(max_workers=1) as pool:
            # decode chunk i + 1 while the card runs chunk i (one ahead)
            nxt = pool.submit(stack, chunks[0])
            for i, chunk in enumerate(chunks):
                x = nxt.result()
                if i + 1 < len(chunks):
                    nxt = pool.submit(stack, chunks[i + 1])
                for p, pred in zip(chunk, predictor(x)):
                    written.append(write(pred, p))
    print(f"wrote {len(written)} masks to {out_dir}/", flush=True)
    return written


def _write_mask(pred: np.ndarray, src_path: str, out_dir: str,
                class_number: int, threshold: float) -> str:
    """``<out_dir>/<stem of src_path>_mask.png``: the label map of
    ``pred``, scaled over 0..255 (JAX drivers.py:819-827)."""
    from .serve import _mask_to_png

    label = ev.label_from_pred(pred, class_number, threshold)
    dst = os.path.join(out_dir, os.path.splitext(
        os.path.basename(src_path))[0] + "_mask.png")
    with open(dst, "wb") as f:
        f.write(_mask_to_png(label, max(class_number, 1) + 1))
    return dst
