"""Model zoo of the port (the flagship UNet++ so far)."""
from .decoders import GridDecoder, build_decoder  # noqa: F401
from .encoders import LatentLayer, ScratchEncoder  # noqa: F401
from .segmodel import SegModel, model_selector  # noqa: F401
