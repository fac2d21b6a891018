"""Visualization helpers (port of the JAX package's ``utils/viz.py``;
reference utils.py:7-38, 130-148): prediction/overlay panels, image grids,
histograms, label-count printing. Host only: numpy, with matplotlib
imported when a figure is drawn (Agg backend, headless); pass save_path to
write a PNG instead of showing a window."""

from typing import Optional, Sequence

import numpy as np


def _plt():
    import matplotlib
    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt
    return plt


def _to_img(x):
    x = np.asarray(x, dtype=np.float32)
    if x.ndim == 3 and x.shape[-1] == 1:
        x = x[..., 0]
    mx = x.max()
    if mx > 1.0:
        x = x / max(mx, 1e-6)
    return np.clip(x, 0, 1)


def plot_prediction(display_list: Sequence, only_prediction: bool = True,
                    show_overlay: bool = True, save_path: Optional[str] = None):
    """Input / (true mask) / prediction panel with an optional overlay;
    written to save_path when given, else shown."""
    plt = _plt()
    titles = ["Input Image", "True Mask", "Predicted Mask"]
    n = len(display_list) + (1 if show_overlay else 0)
    fig, axes = plt.subplots(1, n, figsize=(6 * n, 6))
    axes = np.atleast_1d(axes)
    for i, item in enumerate(display_list):
        title = titles[-1] if (only_prediction and i == 1) else titles[min(i, 2)]
        axes[i].set_title(title)
        axes[i].imshow(_to_img(item))
        axes[i].axis("off")
    if show_overlay:
        axes[-1].set_title("Overlay")
        axes[-1].imshow(_to_img(display_list[0]))
        axes[-1].imshow(_to_img(display_list[-1]), alpha=0.5)
        axes[-1].axis("off")
    if save_path:
        fig.savefig(save_path, dpi=120, bbox_inches="tight")
        plt.close(fig)
    else:
        plt.show()
    return fig


def plot_images(image_list: Sequence, rows: int, columns: int,
                save_path: Optional[str] = None):
    """The images on a rows x columns grid."""
    plt = _plt()
    fig = plt.figure(figsize=(3 * columns, 3 * rows))
    for i, img in enumerate(image_list):
        ax = fig.add_subplot(rows, columns, i + 1)
        ax.imshow(_to_img(img))
        ax.axis("off")
    if save_path:
        fig.savefig(save_path, dpi=120, bbox_inches="tight")
        plt.close(fig)
    else:
        plt.show()
    return fig


def plot_image(image, save_path: Optional[str] = None):
    return plot_images([image], 1, 1, save_path=save_path)


def plot_histogram(image, save_path: Optional[str] = None):
    """Histogram of the image's values in 255 bins."""
    plt = _plt()
    fig = plt.figure(figsize=(8, 6))
    plt.hist(np.asarray(image).flatten(), bins=255)
    if save_path:
        fig.savefig(save_path, dpi=120, bbox_inches="tight")
        plt.close(fig)
    else:
        plt.show()
    return fig


def print_labels(masks: Sequence) -> None:
    """Standard vs superres label histograms (reference utils.py:144-148)."""
    titles = ["Standard Labels: ", "Superres Labels: "]
    for i in range(2):
        values, counts = np.unique(np.asarray(masks[i]), return_counts=True)
        print(titles[i] + str(dict(zip(values.tolist(), counts.tolist()))))
