from .evaluate import evaluate_accuracy, plot_confusion_matrix

__all__ = ["evaluate_accuracy", "plot_confusion_matrix"]
