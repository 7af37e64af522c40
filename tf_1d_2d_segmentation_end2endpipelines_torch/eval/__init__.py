"""Evaluation of the port: confusion-matrix metrics, test-time
augmentation and reports (JAX: tf_1d_2d_segmentation_end2endpipelines_tpu/
eval), and the 1D NILM metrics (``nilm``)."""
from .reports import (  # noqa: F401
    export_results_sheet,
    have_matplotlib,
    plot_conf_mat,
    plot_history,
    plot_multiclass_precision_recall_curves,
    plot_multiclass_roc,
    plot_prediction_distributions,
    plot_sample_grid,
)
from .segmetrics import (  # noqa: F401
    confusion_matrix_update,
    dice,
    evaluation_table,
    init_confusion_matrix,
    label_from_pred,
    one_hot_encoding,
    per_class_binary_counts,
    reverse_one_hot_encoding,
)
from .nilm import (  # noqa: F401
    calculate_deoi,
    calculate_ea,
    calculate_jeoi,
    calculate_sae,
    construction_error,
)
from .tta import TTA_1D, TTA_2D, make_tta_fn, parse_tta  # noqa: F401
