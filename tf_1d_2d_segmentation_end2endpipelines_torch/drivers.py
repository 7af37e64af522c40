"""Model building and weight restore for the port's verbs
(JAX: tf_1d_2d_segmentation_end2endpipelines_tpu/drivers.py:54-138).

Weights live in ``<save_dir>/Fold_<fold>/best.pt``: a ``state_dict`` of the
port's model (``utils/flax_to_torch.py`` makes one from a flax tree).
"""
from __future__ import annotations

import os
import typing as tp

import torch

from .models import model_selector
from .utils.config import TrainConfig

#: file name of a fold's serving weights under its checkpoint directory
BEST_WEIGHTS = "best.pt"


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
        length=cfg.imlength,
        width=cfg.imwidth,
        model_width=cfg.model_width,
        model_depth=cfg.model_depth,
        num_channels=cfg.num_channels,
        output_nums=cfg.output_nums,
        ds=cfg.d_s, ae=cfg.a_e, ag=cfg.a_g, lstm=cfg.lstm,
        dense_loop=cfg.dense_loop,
        is_transconv=cfg.is_transconv,
        final_activation=cfg.final_activation,
        train_mode=cfg.train_mode,
        dtype=_resolve_dtype(cfg, dtype),
        generator=generator,
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
                   seed: tp.Optional[int] = None) -> torch.nn.Module:
    """Build the model with weights drawn from ``seed`` (default: the INI
    ``seed``), load ``<ckpt_dir>/best.pt`` over them when it exists (warn
    when absent), move it to ``device`` and switch it to eval mode."""
    device = resolve_device(device)
    gen = torch.Generator().manual_seed(cfg.seed if seed is None else seed)
    model = _build_model(cfg, dtype=dtype, generator=gen)
    path = os.path.join(ckpt_dir, BEST_WEIGHTS)
    if os.path.exists(path):
        model.load_state_dict(torch.load(path, map_location="cpu",
                                         weights_only=True))
    else:
        print(f"WARNING: no 'best' checkpoint under {ckpt_dir}; "
              f"{action} freshly initialized weights", flush=True)
    return model.to(device).eval()
