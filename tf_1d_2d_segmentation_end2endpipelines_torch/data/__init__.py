"""Input pipeline of the port: host numpy and PIL; ``.pt`` signal sets."""
from .generators import (  # noqa: F401
    PrefetchLoader,
    SegmentationFolderDataset,
    SubsetDataset,
    augment_pair,
    load_image,
    split_dataset,
)
from .pyramid import DS_TYPES, prepare_train_dict  # noqa: F401
from .pt_io import (  # noqa: F401
    load_pt,
    load_signal_dataset,
    load_signal_inputs,
    normalize_signal_array,
    save_pt,
)
from .synthetic import (  # noqa: F401
    batches,
    synthetic_images,
    synthetic_signals,
    write_image_folder,
)
