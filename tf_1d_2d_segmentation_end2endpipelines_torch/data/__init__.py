"""Input pipeline of the port: host numpy and PIL."""
from .generators import (  # noqa: F401
    PrefetchLoader,
    SegmentationFolderDataset,
    SubsetDataset,
    augment_pair,
    load_image,
    split_dataset,
)
from .pyramid import DS_TYPES, prepare_train_dict  # noqa: F401
from .synthetic import synthetic_images, write_image_folder  # noqa: F401
