"""The pretrained-encoder path's parameter trees against the JAX
package's (``jax.eval_shape``: nothing is compiled or run): the W4 UNet
on each of the 33 backbones, the depths 2 to 5 spread over them
(``max_tap`` prunes both graphs alike, inside a stage or a block), and
each of the 16 ``DECODER_NAMES`` on a MobileNet, on its tap projectors'
branch: every flax leaf fills one torch key of its shape, and the
parameter counts agree.  Numerics: tests/test_torch_backbones_zoo.py."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tf_1d_2d_segmentation_end2endpipelines_tpu.models import (  # noqa: E402
    SegModel as JaxSegModel)
from tf_1d_2d_segmentation_end2endpipelines_tpu.models.decoders import (  # noqa: E402
    DECODER_NAMES)
from tf_1d_2d_segmentation_end2endpipelines_torch.models import (  # noqa: E402
    SegModel)
from tf_1d_2d_segmentation_end2endpipelines_torch.models.backbones import (  # noqa: E402
    BACKBONE_NAMES)
from tf_1d_2d_segmentation_end2endpipelines_torch.utils.flax_to_torch import (  # noqa: E402
    flax_to_state_dict)


def _leaf_for_leaf(jm, tm, size):
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, size, size, 3)))
    variables = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    sd = flax_to_state_dict(variables, tm.state_dict())
    assert sorted(sd) == sorted(tm.state_dict())
    assert sum(int(np.prod(s.shape)) for s in jax.tree.leaves(
        shapes["params"])) == sum(p.numel() for p in tm.parameters())


#: the depth each backbone is built at (max_tap 2 to 5, each class at
#: several; the deepest graphs at the lower ones, which keep the test fast)
DEPTHS = {"ResNet50": 5, "ResNet101": 3, "ResNet152": 2, "ResNet50V2": 5,
          "ResNet101V2": 4, "ResNet152V2": 2, "VGG16": 5, "VGG19": 4,
          "DenseNet121": 5, "DenseNet169": 3, "DenseNet201": 2, "CheXNet": 4,
          "MobileNet": 5, "MobileNetV2": 4, "MobileNetV3Small": 5,
          "MobileNetV3Large": 3, "InceptionV3": 5, "InceptionResNetV2": 3,
          "EfficientNetB0": 5, "EfficientNetB1": 4, "EfficientNetB2": 3,
          "EfficientNetB3": 2, "EfficientNetB4": 3, "EfficientNetB5": 2,
          "EfficientNetB6": 2, "EfficientNetB7": 2, "EfficientNetV2B0": 5,
          "EfficientNetV2B1": 4, "EfficientNetV2B2": 3, "EfficientNetV2B3": 2,
          "EfficientNetV2S": 4, "EfficientNetV2M": 3, "EfficientNetV2L": 2}


@pytest.mark.parametrize("name", BACKBONE_NAMES)
def test_unet_on_every_backbone_maps_leaf_for_leaf(name):
    """The W4 UNet on each backbone at its depth in ``DEPTHS``: the
    backbone stops at tap min(D, 5) inside its stage or block as the JAX
    one does; every flax leaf fills one torch key of its shape."""
    assert sorted(DEPTHS) == sorted(BACKBONE_NAMES)
    D = DEPTHS[name]
    kw = dict(model_width=4, model_depth=D, output_nums=1,
              train_mode="pretrained_encoder", backbone=name)
    tm = SegModel("UNet", in_channels=3, **kw)
    _leaf_for_leaf(JaxSegModel(decoder_name="UNet", **kw), tm, 64)
    assert len(getattr(tm, tm._encoder).tap_features) == min(D, 5) + 1


@pytest.mark.parametrize("name", DECODER_NAMES)
def test_every_decoder_on_a_backbone_maps_leaf_for_leaf(name):
    """Each of the 16 ``DECODER_NAMES`` on MobileNet at W4/D3 (the FPN
    genre for the FPN decoders, as the JAX INI pairs them), each on its
    tap projectors' branch."""
    genre = "FPN" if name.endswith("FPN") else "UNet"
    kw = dict(model_width=4, model_depth=3, output_nums=1, genre=genre,
              train_mode="pretrained_encoder", backbone="MobileNet")
    _leaf_for_leaf(JaxSegModel(decoder_name=name, **kw),
                   SegModel(name, in_channels=3, **kw), 64)
