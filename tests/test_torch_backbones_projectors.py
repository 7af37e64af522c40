"""The gated tap projectors (MultiResUNet, KSSNet, UNet4P/UNet4PV2, AHNet)
and ``a_e`` on a narrow MobileNet against the JAX package, held to
``assert_model_matches_jax`` (moved from test_torch_backbones_zoo.py to
keep each file short on one test worker)."""
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


@pytest.fixture
def narrow_mobilenet(monkeypatch):
    """Both packages' ``get_backbone`` give MobileNet at alpha 0.25."""
    monkeypatch.setattr(jbackbones, "get_backbone",
                        lambda name, dtype=jnp.float32, max_tap=5:
                        jconv.MobileNetBackbone(alpha=0.25, dtype=dtype,
                                                max_tap=max_tap))
    monkeypatch.setattr(segmodel, "get_backbone",
                        lambda name, **kw: convnets.MobileNetBackbone(
                            alpha=0.25, **kw))


# (decoder, depth, ds, ae): each projector branch (UNet4P at depth 3 runs
# four, the fourth its bottom)
PROJECTOR_CASES = [("MultiResUNet", 1, 0, 0), ("KSSNet", 2, 1, 0),
                   ("UNet4P", 3, 1, 0), ("UNet4PV2", 2, 0, 0),
                   ("AHNet", 3, 0, 0), ("UNet", 3, 0, 1)]


_HEADS = {"MultiResUNet": ("ChainDecoder_0", "UNet"),
          "KSSNet": ("ChainDecoder_0", "UNet"),
          "UNet4P": ("GridDecoder_0", "UNetPP"),
          "AHNet": ("GridDecoder_0", "UNetPP"),
          "UNet4PV2": ("FullScaleDecoder_0", "UNet"),
          "UNet": ("ChainDecoder_0", "UNet")}


@pytest.mark.parametrize("name,D,ds,ae", PROJECTOR_CASES,
                         ids=[f"{n}-D{d}-ds{s}-ae{a}"
                              for n, d, s, a in PROJECTOR_CASES])
def test_projectors_on_a_backbone_match_jax(narrow_mobilenet, name, D, ds,
                                            ae):
    """W4 on (2, 32, 32, 3), trainable backbone: held to
    ``assert_model_matches_jax`` with JAX's step in float64, gradients and
    statistics relative to their size where that is above 1.  The
    gated projectors read the shallower projected taps (KSSNet and UNet4P
    their pools by 2**(level - k), each tap pooled once; AHNet each
    through its own ResPath); ``a_e`` sizes its bottleneck by the
    backbone's tap D."""
    kw = dict(output_nums=1, ds=ds, ae=ae, feature_number=8,
              final_activation="sigmoid", train_mode="pretrained_encoder",
              backbone="MobileNet", backbone_trainable=True)
    size = 32
    jm = JaxSegModel(decoder_name=name, model_width=4, model_depth=D, **kw)
    tm = SegModel(name, 4, D, in_channels=3, input_size=(size, size), **kw)
    if ae:
        assert tm.FeatureExtractionBlock_0.spatial == (size >> D,) * 2
    assert_model_matches_jax(jm, tm, ds, *_HEADS[name], depth=D, size=size,
                             step_dtype=jnp.float64, relative=True)
