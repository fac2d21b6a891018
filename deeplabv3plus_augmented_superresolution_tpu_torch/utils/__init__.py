from .checkpoint import load_train_state, restore_opt_state, save_train_state
from .profiling import StageTimer, device_summary, trace_to
from .viz import plot_histogram, plot_image, plot_images, plot_prediction, print_labels

__all__ = ["StageTimer", "trace_to", "device_summary", "load_train_state",
           "restore_opt_state", "save_train_state", "plot_prediction", "plot_images",
           "plot_image", "plot_histogram", "print_labels"]
