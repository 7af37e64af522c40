"""Pretrained-encoder backbones of the port (JAX: tf_1d_2d_segmentation_
end2endpipelines_tpu/models/backbones/__init__.py).

Ported: EfficientNet V1, B0-B7 (``efficientnet.py``), with random
weights: ImageNet weights are not in the repository and cannot be
fetched, so ``encoder_weights`` must be ``none``.  Every other name of
the JAX registry raises ``NotImplementedError``; an unknown name the
JAX package's ``ValueError``.
"""
from __future__ import annotations

import typing as tp

import torch

from .efficientnet import EfficientNetBackbone, InputNorm  # noqa: F401

#: every name of the JAX registry (backbones/__init__.py:22-69), in order
BACKBONE_NAMES = (
    "ResNet50", "ResNet101", "ResNet152", "ResNet50V2", "ResNet101V2",
    "ResNet152V2", "VGG16", "VGG19", "DenseNet121", "DenseNet169",
    "DenseNet201", "CheXNet", "MobileNet", "MobileNetV2",
    "MobileNetV3Small", "MobileNetV3Large", "InceptionV3",
    "InceptionResNetV2", "EfficientNetB0", "EfficientNetB1",
    "EfficientNetB2", "EfficientNetB3", "EfficientNetB4", "EfficientNetB5",
    "EfficientNetB6", "EfficientNetB7", "EfficientNetV2B0",
    "EfficientNetV2B1", "EfficientNetV2B2", "EfficientNetV2B3",
    "EfficientNetV2S", "EfficientNetV2M", "EfficientNetV2L")

#: the ported names: EfficientNet V1's (width, depth) multipliers
_EFFICIENTNET_V1 = {
    "EfficientNetB0": (1.0, 1.0), "EfficientNetB1": (1.0, 1.1),
    "EfficientNetB2": (1.1, 1.2), "EfficientNetB3": (1.2, 1.4),
    "EfficientNetB4": (1.4, 1.8), "EfficientNetB5": (1.6, 2.2),
    "EfficientNetB6": (1.8, 2.6), "EfficientNetB7": (2.0, 3.1)}


def get_backbone(name: str, dtype: torch.dtype = torch.float32,
                 max_tap: int = 5, in_channels: int = 3,
                 generator: tp.Optional[torch.Generator] = None,
                 trainable: bool = True) -> EfficientNetBackbone:
    """The backbone ``name`` computing taps 0 .. ``max_tap`` (JAX
    ``get_backbone``), weights from ``generator``: ``ValueError`` for a
    name the JAX registry lacks, ``NotImplementedError`` for one the port
    lacks."""
    if name not in BACKBONE_NAMES:
        raise ValueError(
            f"Unknown backbone {name!r}; available: {BACKBONE_NAMES}")
    if name not in _EFFICIENTNET_V1:
        raise NotImplementedError(
            f"backbone {name!r} is not ported yet (ported: "
            f"{', '.join(_EFFICIENTNET_V1)})")
    width, depth = _EFFICIENTNET_V1[name]
    return EfficientNetBackbone(width, depth, max_tap=max_tap,
                                in_channels=in_channels, dtype=dtype,
                                generator=generator, trainable=trainable)
