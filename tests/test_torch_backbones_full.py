"""The full-width backbones without a width field (MobileNetV3Small, the
Inceptions, EfficientNetV2B0) against the JAX package with the same
variables, every tap in eval and training mode on 64x64, the port in
float64 against JAX's float64 (moved from test_torch_backbones_zoo.py,
whose docstring gives the bars, to keep each file short on one test
worker)."""
import numpy as np
import pytest
torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from test_torch_blocks import nhwc_to_torch, random_variables, torch_to_nhwc  # noqa: E402
from test_torch_config2_models import assert_model_matches_jax  # noqa: E402
from test_torch_pool_factors import _input  # noqa: E402
from tf_1d_2d_segmentation_end2endpipelines_tpu.models import (  # noqa: E402
    SegModel as JaxSegModel)
from tf_1d_2d_segmentation_end2endpipelines_tpu.models import (  # noqa: E402
    backbones as jbackbones)
from tf_1d_2d_segmentation_end2endpipelines_tpu.models.backbones import (  # noqa: E402
    convnets as jconv, efficientnet as jeff, inception as jinc)
from tf_1d_2d_segmentation_end2endpipelines_torch.models import (  # noqa: E402
    SegModel, segmodel)
from tf_1d_2d_segmentation_end2endpipelines_torch.models.backbones import (  # noqa: E402
    base, convnets, efficientnet, inception)
from tf_1d_2d_segmentation_end2endpipelines_torch.train import (  # noqa: E402
    bce_dice_loss, make_optimizer, make_train_step)
from tf_1d_2d_segmentation_end2endpipelines_torch.utils.flax_to_torch import (  # noqa: E402
    flax_to_state_dict)
from test_torch_backbones_zoo import (  # noqa: E402
    _assert_backbone_matches_jax)


FULL = {
    "MobileNetV3Small": (jconv.MobileNetV3Backbone,
                         convnets.MobileNetV3Backbone, dict(size="small")),
    "InceptionV3": (jinc.InceptionV3Backbone, inception.InceptionV3Backbone,
                    {}),
    "InceptionResNetV2": (jinc.InceptionResNetV2Backbone,
                          inception.InceptionResNetV2Backbone, {}),
    "EfficientNetV2B0": (jeff.EfficientNetV2Backbone,
                         efficientnet.EfficientNetV2Backbone,
                         dict(size="b0")),
}


@pytest.mark.parametrize("name", sorted(FULL))
def test_full_width_backbone_forward_equals_flax(name):
    """Every tap of the full graph in eval and in training mode on (2, 64,
    64, 3), the smallest input whose stride-32 tap trains on more than one
    value an image (2 x 2)."""
    jcls, tcls, kw = FULL[name]
    _assert_backbone_matches_jax(
        jcls(**kw), lambda dtype: tcls(**kw, dtype=dtype), 64, vjp=False)
