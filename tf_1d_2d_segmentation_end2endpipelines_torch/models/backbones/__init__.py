"""Pretrained-encoder backbones of the port (JAX: tf_1d_2d_segmentation_
end2endpipelines_tpu/models/backbones/__init__.py).

All 33 names of the JAX registry: ResNet50/101/152 and their V2s, VGG16/19
(``convnets.py``), DenseNet121/169/201 and CheXNet (DenseNet121's graph),
MobileNet V1, V2, V3 small and large, InceptionV3 and InceptionResNetV2
(``inception.py``), EfficientNet B0-B7 and V2 B0-B3/S/M/L
(``efficientnet.py``), with random weights: ImageNet (or CheXNet's
``.h5``) weights are not in the repository and cannot be fetched, so
``encoder_weights`` must be ``none``.  An unknown name raises the JAX
package's ``ValueError``.
"""
from __future__ import annotations

import typing as tp

import torch
from torch import nn

from .convnets import (DenseNetBackbone, MobileNetBackbone,  # noqa: F401
                       MobileNetV2Backbone, MobileNetV3Backbone,
                       ResNetBackbone, ResNetV2Backbone, VGGBackbone)
from .efficientnet import (EfficientNetBackbone,  # noqa: F401
                           EfficientNetV2Backbone, InputNorm)
from .inception import (InceptionResNetV2Backbone,  # noqa: F401
                        InceptionV3Backbone)

#: name -> (class, its keyword arguments), in the JAX registry's order
#: (backbones/__init__.py:36-70)
_REGISTRY: tp.Dict[str, tp.Tuple[tp.Callable[..., nn.Module],
                                 tp.Dict[str, tp.Any]]] = {
    "ResNet50": (ResNetBackbone, dict(blocks=(3, 4, 6, 3))),
    "ResNet101": (ResNetBackbone, dict(blocks=(3, 4, 23, 3))),
    "ResNet152": (ResNetBackbone, dict(blocks=(3, 8, 36, 3))),
    "ResNet50V2": (ResNetV2Backbone, dict(blocks=(3, 4, 6, 3))),
    "ResNet101V2": (ResNetV2Backbone, dict(blocks=(3, 4, 23, 3))),
    "ResNet152V2": (ResNetV2Backbone, dict(blocks=(3, 8, 36, 3))),
    "VGG16": (VGGBackbone, dict(convs=(2, 2, 3, 3, 3))),
    "VGG19": (VGGBackbone, dict(convs=(2, 2, 4, 4, 4))),
    "DenseNet121": (DenseNetBackbone, dict(blocks=(6, 12, 24, 16))),
    "DenseNet169": (DenseNetBackbone, dict(blocks=(6, 12, 32, 32))),
    "DenseNet201": (DenseNetBackbone, dict(blocks=(6, 12, 48, 32))),
    "CheXNet": (DenseNetBackbone, dict(blocks=(6, 12, 24, 16))),
    "MobileNet": (MobileNetBackbone, {}),
    "MobileNetV2": (MobileNetV2Backbone, {}),
    "MobileNetV3Small": (MobileNetV3Backbone, dict(size="small")),
    "MobileNetV3Large": (MobileNetV3Backbone, dict(size="large")),
    "InceptionV3": (InceptionV3Backbone, {}),
    "InceptionResNetV2": (InceptionResNetV2Backbone, {}),
    **{f"EfficientNetB{i}": (EfficientNetBackbone,
                             dict(width=w, depth=d))
       for i, (w, d) in enumerate([(1.0, 1.0), (1.0, 1.1), (1.1, 1.2),
                                   (1.2, 1.4), (1.4, 1.8), (1.6, 2.2),
                                   (1.8, 2.6), (2.0, 3.1)])},
    **{f"EfficientNetV2{s.upper()}": (EfficientNetV2Backbone, dict(size=s))
       for s in ("b0", "b1", "b2", "b3", "s", "m", "l")},
}

#: every name of the JAX registry, in its order
BACKBONE_NAMES = tuple(_REGISTRY)


def get_backbone(name: str, dtype: torch.dtype = torch.float32,
                 max_tap: int = 5, in_channels: int = 3,
                 generator: tp.Optional[torch.Generator] = None,
                 trainable: bool = True) -> nn.Module:
    """The backbone ``name`` computing taps 0 .. ``max_tap`` (JAX
    ``get_backbone``), weights from ``generator``; ``ValueError`` for a
    name the JAX registry lacks."""
    if name not in _REGISTRY:
        raise ValueError(
            f"Unknown backbone {name!r}; available: {BACKBONE_NAMES}")
    cls, kw = _REGISTRY[name]
    return cls(**kw, max_tap=max_tap, in_channels=in_channels, dtype=dtype,
               generator=generator, trainable=trainable)
