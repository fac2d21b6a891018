"""Path conventions and dataset filtering (port of the JAX package's
``data/paths.py``; reference superres_utils.py:9-53, :93-105 and the
output-directory names of generate_augmented_copies.py:62-64)."""

import os
from typing import List, Optional

import numpy as np

from .io import load_image


def _basename_sort_key(path: str):
    """Numeric sort for VOC ids like 2007_000032 (which parse as ints:
    underscores are digit separators, reference superres_utils.py:26-27),
    lexicographic for anything else (e.g. synthetic scene names)."""
    stem = os.path.basename(path).split(".")[0]
    try:
        return (0, int(stem), "")
    except ValueError:
        return (1, 0, stem)


def get_img_paths(image_list_path: str, image_folder: str, is_png: bool = False,
                  sort: bool = True) -> List[str]:
    ext = ".png" if is_png else ".jpg"
    with open(image_list_path) as f:
        paths = [os.path.join(image_folder, line.rstrip() + ext) for line in f]
    if sort:
        paths = sorted(paths, key=_basename_sort_key)
    return paths


def class_in_image(image_path: str, class_id: int, image_size=(512, 512)) -> bool:
    mask_path = image_path.replace("JPEGImages", "SegmentationClassAug").replace(
        "jpg", "png")
    mask = load_image(mask_path, image_size=image_size, normalize=False,
                      is_png=True, resize_method="nearest")
    return bool(np.any(mask == class_id))


def filter_images_by_class(path_list: List[str], filter_class_id: int,
                           num_images: Optional[int] = None,
                           image_size=(512, 512), num_workers: int = 16) -> List[str]:
    """The images whose GT mask holds the class, in list order, stopping at
    num_images; the masks are decoded in a thread pool."""
    from concurrent.futures import ThreadPoolExecutor

    max_images = num_images if num_images is not None else len(path_list)
    found: List[str] = []
    chunk = max(4 * num_workers, 64)
    with ThreadPoolExecutor(max_workers=num_workers) as pool:
        for start in range(0, len(path_list), chunk):
            batch = path_list[start:start + chunk]
            hits = pool.map(
                lambda p: class_in_image(p, filter_class_id, image_size), batch)
            for path, hit in zip(batch, hits):
                if hit:
                    found.append(path)
                    if len(found) == max_images:
                        return found
    return found


def list_precomputed_data_paths(root_dir: str, sort: bool = False) -> List[str]:
    paths = []
    for path, _, files in os.walk(root_dir):
        for filename in files:
            if filename.endswith(".hdf5"):
                paths.append(os.path.join(path, filename))
    if sort:
        paths = sorted(paths, key=_basename_sort_key)
    return paths


def augmented_copies_dir(superres_root: str, backbone: str, mode: str,
                         class_id: int, num_aug: int,
                         use_validation: bool = False) -> str:
    """<root>/augmented_copies/<backbone>_<mode>_<classid>_<numaug>[_validation]."""
    suffix = "_validation" if use_validation else ""
    return os.path.join(superres_root, "augmented_copies",
                        f"{backbone}_{mode}_{class_id}_{num_aug}{suffix}")


def standard_output_dir(superres_root: str, backbone: str, class_id: int,
                        use_validation: bool = False) -> str:
    """<root>/standard_output/<backbone>_<classid>[_validation]."""
    suffix = "_validation" if use_validation else ""
    return os.path.join(superres_root, "standard_output",
                        f"{backbone}_{class_id}{suffix}")
