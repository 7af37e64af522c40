"""Model zoo of the port: the from-scratch UNet, UNetE, UNetP, UNet++,
UNet3+, MultiResUNet, MultiResUNet3+ and KSSNet."""
from .decoders import (  # noqa: F401
    ChainDecoder,
    FullScaleDecoder,
    GridDecoder,
    build_decoder,
)
from .encoders import LatentLayer, ScratchEncoder  # noqa: F401
from .segmodel import SegModel, model_selector  # noqa: F401
