"""Block library and kernels of the port."""
from .blocks import (  # noqa: F401
    LEAKY_SLOPE,
    BatchNorm,
    ConvBlock,
    DenseBlock,
    HeadConv,
    TransConv,
    apply_activation,
    concat,
    downsample_pool,
    get_activation,
    upsample,
)
