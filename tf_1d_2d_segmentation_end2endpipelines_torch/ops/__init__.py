"""Block library and kernels of the port."""
from .blocks import (  # noqa: F401
    LEAKY_SLOPE,
    AttentionGate,
    BatchNorm,
    ConvBlock,
    DenseBlock,
    HeadConv,
    MultiResBlock,
    ResPath,
    TransConv,
    apply_activation,
    concat,
    downsample_pool,
    get_activation,
    multires_features,
    multires_widths,
    upsample,
)
