"""Training of the port (JAX: tf_1d_2d_segmentation_end2endpipelines_tpu/
train): the loss, metric and optimizer registries, gradient clipping, the
train/eval/predict steps, callbacks, state_dict checkpoints and the
``Trainer``."""
from .callbacks import (  # noqa: F401
    BestTracker,
    EarlyStopping,
    LearningRateScheduler,
    NaNGuard,
    ReduceLROnPlateau,
    cosine_decay,
    exponential_decay,
    infer_mode,
)
from .checkpoint import CheckpointManager  # noqa: F401
from .losses import (  # noqa: F401
    LOSSES,
    bce_dice_loss,
    binary_crossentropy,
    categorical_crossentropy,
    deep_supervision_loss,
    default_ds_weights,
    dice_loss,
    get_loss,
)
from .metrics import METRIC_NAMES, Metric, make_metric  # noqa: F401
from .optimizers import (  # noqa: F401
    OPTIMIZER_NAMES,
    clip_gradients,
    get_learning_rate,
    make_optimizer,
    set_learning_rate,
)
from .state import (  # noqa: F401
    make_eval_step,
    make_predict_step,
    make_train_step,
)
from .trainer import Trainer  # noqa: F401
