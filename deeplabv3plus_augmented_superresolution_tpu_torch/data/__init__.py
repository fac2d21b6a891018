from .io import load_image, save_img

__all__ = ["load_image", "save_img"]
