"""Model zoo of the port: the from-scratch UNet, UNetE, UNetP, UNet++,
UNet3+, MultiResUNet, MultiResUNet3+ and KSSNet, and the UNet genre on an
EfficientNet V1 encoder (``backbones``); in 1D, every ``UNet1D`` arch
(``api_1d``), BCDUNet, SEDUNet, IBAUNet and NABNet (``specials_1d``),
TernausNet, AlbUNet, LinkNet and FPN (``extra_1d``), MLMRSNet
(``mlmrsnet``), SAUNet (``saunet``) and Dense_Inception_UNet
(``dense_inception``), each through its reference facade."""
from .api_1d import (  # noqa: F401
    ARCH_NAMES_1D,
    SegModel1D,
    UNet1D,
    model_selector_1d,
)
from .dense_inception import Dense_Inception_UNet  # noqa: F401
from .decoders import (  # noqa: F401
    ChainDecoder,
    FullScaleDecoder,
    GridDecoder,
    build_decoder,
)
from .encoders import LatentLayer, ScratchEncoder  # noqa: F401
from .extra_1d import FPN, AlbUNet, LinkNet, TernausNet  # noqa: F401
from .mlmrsnet import MLMRSNet  # noqa: F401
from .saunet import SAUNet  # noqa: F401
from .segmodel import SegModel, model_selector  # noqa: F401
from .specials_1d import BCDUNet, IBAUNet, NABNet, SEDUNet  # noqa: F401
