from .io import load_image, save_img
from .synthetic import synthetic_batch, synthetic_scene

__all__ = ["load_image", "save_img", "synthetic_batch", "synthetic_scene"]
