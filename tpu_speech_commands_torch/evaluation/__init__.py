from .evaluate import (evaluate_accuracy, evaluate_with_predict_fn,
                       plot_confusion_matrix)
from .statistics import clever_format, count_params, get_model_statistics

__all__ = ["clever_format", "count_params", "evaluate_accuracy",
           "evaluate_with_predict_fn", "get_model_statistics",
           "plot_confusion_matrix"]
