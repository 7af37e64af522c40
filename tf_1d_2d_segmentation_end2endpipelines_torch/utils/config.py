"""The typed training, test and 1D signal configs and their INI loaders,
with the schema of tf_1d_2d_segmentation_end2endpipelines_tpu/utils/
config.py (``TrainConfig`` :20, ``TestConfig`` :187, ``Signal1DConfig``
:228, ``load_train_config`` :333, ``load_test_config`` :341,
``load_signal_config`` :349, ``save_signal_config`` :357): a reference
Train_Configs.ini or Test_Configs.ini, or a Signal_Configs.ini, loads
unchanged.  The field comments live in the JAX package.
"""
from __future__ import annotations

import configparser
import dataclasses as dc
import typing as tp


def _to_bool(v: str) -> bool:
    return str(v).strip().lower() in ("1", "true", "yes", "on")


@dc.dataclass
class TrainConfig:
    train_dir: str = "Data/Train"
    val_dir: str = "Data/Val"
    data_loading_mode: str = "Custom_DataLoader"
    independent_val_set: bool = True
    validation_portion: float = 0.0
    imlength: int = 512
    imwidth: int = 512
    image_color_mode: str = "rgb"
    mask_color_mode: str = "grayscale"
    num_channels: int = 3
    normalizing_factor_img: float = 255.0
    normalizing_factor_msk: float = 255.0
    model_genre: str = "UNet"
    encoder_mode: str = "from_scratch"   # reference: train_mode
    encoder_name: str = "ResNet50"
    encoder_trainable: bool = False
    encoder_weights: str = "imagenet"
    decoder_name: str = "UNet"
    model_width: int = 16
    model_depth: int = 5
    output_nums: int = 1
    a_e: int = 0
    a_g: int = 0
    lstm: int = 0
    dense_loop: int = 2
    feature_number: int = 1024
    is_transconv: bool = True
    alpha: float = 1.0
    q_onn: int = 3
    final_activation: str = "sigmoid"
    class_number: int = 1
    batch_size: int = 4
    learning_rate: float = 2e-4
    start_fold: int = 1
    end_fold: int = 1
    monitor_param: str = "val_loss"
    patience_amount: int = 20
    patience_amount_rlronp: int = 10
    patience_mode: str = "min"
    rlronp_factor: float = 0.1
    num_epochs: int = 200
    loss_function: str = "BinaryCrossentropy"
    optimizer_function: str = "Adam"
    metric_list: tp.Tuple[str, ...] = ("MeanSquaredError",)
    save_history: bool = True
    load_weights: bool = True
    save_dir: str = "Results"
    task_name: str = "None"
    seed: int = 1
    compute_dtype: str = "float32"
    remat: str = ""
    accumulation_steps: int = 1
    model_parallel: int = 1
    spatial_parallel: int = 1
    pipeline_parallel: int = 1
    exact_resume: bool = False
    zero1: bool = False
    clipnorm: float = 0.0
    clipvalue: float = 0.0
    global_clipnorm: float = 0.0
    tensorboard_dir: str = ""
    augment: bool = False
    augment_device: bool = False
    cache_data: bool = False
    ema_decay: float = 0.0
    patchify: bool = False
    patch_width: int = 64
    patch_height: int = 64
    overlap_ratio: float = 0.0
    d_s: int = 0
    ds_type: str = "UNet"

    @property
    def train_mode(self) -> str:
        return ("pretrained_encoder" if self.encoder_mode
                == "pretrained_encoder" else "from_scratch")


@dc.dataclass
class TestConfig:
    test_dir: str = "Data/Test"
    imheight: int = 512
    imwidth: int = 512
    image_color_mode: str = "rgb"
    mask_color_mode: str = "grayscale"
    num_channels: int = 3
    class_number: int = 1
    labels: tp.Tuple[str, ...] = ()
    encoder_mode: str = "from_scratch"
    encoder_name: str = "ResNet50"
    decoder_name: str = "UNetPP"
    batch_size: int = 4
    normalizing_factor_img: float = 255.0
    normalizing_factor_msk: float = 255.0
    start_fold: int = 1
    end_fold: int = 1
    threshold: float = 0.5
    save_dir: str = "Results"
    patchify: bool = False
    patch_width: int = 64
    patch_height: int = 64
    overlap_ratio: float = 0.0
    d_s: int = 0
    roc_from_scores: bool = False
    tta: str = ""


@dc.dataclass
class Signal1DConfig:
    """The 1D signal pipeline's config (section ``[SIGNAL1D]``), the JAX
    fields and defaults in the JAX order (so ``resume_token`` gives the
    JAX digits)."""
    train_set: str = "Data/Train_Set.pt"
    val_set: str = ""
    test_set: str = "Data/Test_Set.pt"
    x_key: str = "samples"
    y_key: str = "labels"
    signal_length: int = 1024
    num_channel: int = 1
    model_name: str = "UNet"
    model_depth: int = 3
    model_width: int = 16
    kernel_size: int = 3
    problem_type: str = "Regression"
    output_nums: int = 1
    d_s: int = 0
    a_e: int = 0
    a_g: int = 0
    lstm: int = 0
    alpha: float = 1.0
    q_onn: int = 3
    t: int = 2
    dense_loop: int = 2
    feature_number: int = 1024
    is_transconv: bool = True
    cardinality: int = 5
    pooling_type: str = "avg"
    se_ratio: int = 16
    block_size: int = 7
    keep_prob: float = 0.9
    ds_type: str = "UNet"
    batch_size: int = 8
    learning_rate: float = 3e-4
    num_epochs: int = 50
    loss_function: str = "MeanAbsoluteError"
    optimizer_function: str = "Adam"
    metric_list: tp.Tuple[str, ...] = ("MeanSquaredError",)
    monitor_param: str = "val_loss"
    patience_amount: int = 20
    patience_amount_rlronp: int = 10
    patience_mode: str = "min"
    rlronp_factor: float = 0.5
    save_history: bool = True
    load_weights: bool = True
    save_dir: str = "Results_1D"
    seed: int = 1
    compute_dtype: str = "float32"
    remat: str = ""
    accumulation_steps: int = 1
    model_parallel: int = 1
    spatial_parallel: int = 1
    zero1: bool = False
    pipeline_parallel: int = 1
    exact_resume: bool = False
    clipnorm: float = 0.0
    clipvalue: float = 0.0
    global_clipnorm: float = 0.0
    tensorboard_dir: str = ""
    ema_decay: float = 0.0
    tta: str = ""


_T = tp.TypeVar("_T")


def _coerce(field: dc.Field, raw: str):
    t = field.type
    if t in (bool, "bool"):
        return _to_bool(raw)
    if t in (int, "int"):
        return int(float(raw))
    if t in (float, "float"):
        return float(raw)
    if "Tuple" in str(t):
        parts = [p.strip() for p in str(raw).split(",") if p.strip()]
        return tuple(parts)
    return str(raw)


def _load_section(cls: tp.Type[_T], section: tp.Mapping[str, str]) -> _T:
    fields = {f.name: f for f in dc.fields(cls)}
    kwargs = {}
    for key, raw in section.items():
        name = key.lower()
        if name in fields:
            kwargs[name] = _coerce(fields[name], raw)
    return cls(**kwargs)


def load_train_config(path: str) -> TrainConfig:
    """Load a reference-format Train_Configs.ini (section [TRAIN])."""
    parser = configparser.ConfigParser()
    with open(path) as f:
        parser.read_file(f)
    return _load_section(TrainConfig, parser["TRAIN"])


def load_test_config(path: str) -> TestConfig:
    """Load a reference-format Test_Configs.ini (section [TEST])."""
    parser = configparser.ConfigParser()
    with open(path) as f:
        parser.read_file(f)
    return _load_section(TestConfig, parser["TEST"])


def load_signal_config(path: str) -> Signal1DConfig:
    """Load a Signal_Configs.ini (section [SIGNAL1D])."""
    parser = configparser.ConfigParser()
    with open(path) as f:
        parser.read_file(f)
    return _load_section(Signal1DConfig, parser["SIGNAL1D"])


def _save_section(cfg, section: str, path: str) -> None:
    parser = configparser.ConfigParser()
    parser[section] = {
        k: (",".join(v) if isinstance(v, tuple) else str(v))
        for k, v in dc.asdict(cfg).items()}
    with open(path, "w") as f:
        parser.write(f)


def save_train_config(cfg: TrainConfig, path: str) -> None:
    """Write ``cfg`` as an INI that ``load_train_config`` (here and in the
    JAX package) reads back."""
    _save_section(cfg, "TRAIN", path)


def save_signal_config(cfg: Signal1DConfig, path: str) -> None:
    """Write ``cfg`` as an INI that ``load_signal_config`` (here and in
    the JAX package) reads back."""
    _save_section(cfg, "SIGNAL1D", path)


#: fields that do not define the training trajectory: bookkeeping,
#: output locations, fold and epoch selection, restore directives and
#: test-only keys (JAX config.py:388-394).  Editing one of these between a
#: preemption and the relaunch keeps the resume state.
_RESUME_TOKEN_EXCLUDE = frozenset({
    "num_epochs", "start_fold", "end_fold", "save_dir", "save_history",
    "tensorboard_dir", "task_name", "load_weights", "test_set", "tta",
    "threshold",
})


def resume_token(cfg: tp.Union[TrainConfig, Signal1DConfig]) -> str:
    """Fingerprint of the training-defining fields of ``cfg``, stored in
    exact-resume checkpoints (JAX config.py:397-410): the same config
    resumes, a changed one (a fine-tune stage into the same ``save_dir``)
    starts its stage fresh.  The same 16 hex digits as the JAX package's
    for the same INI: both configs have the same fields in the same
    order."""
    import hashlib

    items = sorted((k, v) for k, v in dc.asdict(cfg).items()
                   if k not in _RESUME_TOKEN_EXCLUDE)
    return hashlib.sha256(repr(items).encode()).hexdigest()[:16]


def unported_train_keys(cfg: TrainConfig) -> tp.List[str]:
    """The INI settings of ``cfg`` the port's ``train`` verb does not take
    yet, as ``key = value`` strings (empty when it takes them all): with
    a pretrained encoder, ``encoder_weights`` other than ``none`` (no
    ImageNet or ``.h5`` weights are loaded: ``none`` trains from random
    weights), and the multi-device keys.  A backbone the port lacks
    raises when the model is built."""
    checks = (
        ("encoder_weights", cfg.train_mode == "pretrained_encoder"
         and cfg.encoder_weights.strip().lower() != "none"),
        ("model_parallel", cfg.model_parallel > 1),
        ("spatial_parallel", cfg.spatial_parallel > 1),
        ("pipeline_parallel", cfg.pipeline_parallel > 1),
        ("zero1", cfg.zero1),
    )
    return [f"{key} = {getattr(cfg, key)!r}" for key, bad in checks if bad]


def unported_signal_keys(cfg: Signal1DConfig) -> tp.List[str]:
    """The settings of ``cfg`` the port's 1D verbs do not take, as
    ``key = value`` strings (empty when it takes them all): ``lstm`` on
    ``MultiResUNet3P`` (whose reference branch crashes; the JAX package
    refuses it) and the multi-device keys.  Every ``model_name`` of the
    JAX package is built; an unknown one raises its ``ValueError`` when
    the model is built, before anything is written."""
    checks = (
        ("lstm", bool(cfg.lstm) and cfg.model_name == "MultiResUNet3P"),
        ("model_parallel", cfg.model_parallel > 1),
        ("spatial_parallel", cfg.spatial_parallel > 1),
        ("pipeline_parallel", cfg.pipeline_parallel > 1),
        ("zero1", cfg.zero1),
    )
    return [f"{key} = {getattr(cfg, key)!r}" for key, bad in checks if bad]
