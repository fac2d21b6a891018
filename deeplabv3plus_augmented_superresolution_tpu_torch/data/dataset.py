"""PascalVOC2012 dataset class with a prefetching host loader (port of the
JAX package's ``data/dataset.py``; the reference's
data_scripts/pascal_voc_dataset.py, pascal_voc_dataset.py:113-340).

A split's basenames, the .npz array-record export, and a threaded
prefetcher that loads each pair, applies ``host_augment.random_transform``
and yields numpy batches for the training loop to move to the card, so that
host work overlaps the card's steps.

The file decode is one function, ``decode_files``, that ``load_pair`` calls
through ``self.decode``: a caller may pass its own ``decode`` (a basename to
the decoded image and label map) and keep everything after it, the resize
to ``image_size``, the /255, shuffling, augmentation and prefetch. PIL is
imported only inside the default decode.
"""

import os
import queue
import threading
from typing import Callable, Iterator, Optional, Tuple

import numpy as np

from . import voc
from .host_augment import random_transform
from .io import decode_image, prepare_image

# The augmentation ``batches(augment=True)`` applies when the dataset was
# given no parameters (the JAX package's defaults).
DEFAULT_AUGMENTATION = {
    "flip_lr": True,
    "rotation_range": (-10.0, 10.0),
    "zoom_range": (0.8, 1.2),
    "brightness_range": (-20, 20),
}

Decode = Callable[[str], Tuple[np.ndarray, np.ndarray]]


class PascalVOC2012Dataset:
    """Segmentation-split access over a prepared VOC tree.

    decode: basename -> (image (H, W, 3), labels (H, W) or (H, W, 1)), any
    numeric dtype with 0..255 values, at any size; by default the tree's
    ``JPEGImages/<name>.jpg`` and its label PNG (``decode_files``)."""

    CLASS_LABELS = voc.PASCAL_CLASSES
    IGNORE_LABEL = 255

    def __init__(self, pascal_root: str, image_size=(512, 512),
                 augmentation_params: Optional[dict] = None,
                 decode: Optional[Decode] = None):
        self.pascal_root = pascal_root
        self.image_size = tuple(image_size)
        self.augmentation_params = augmentation_params
        self.decode = decode or self.decode_files

    def get_basenames(self, split: str):
        """(reference pascal_voc_dataset.py:113)"""
        return voc.get_basenames(split, self.pascal_root)

    def export_arrayrecord(self, split: str, dest_dir: str,
                           limit: Optional[int] = None) -> str:
        """(replaces export_tfrecord, reference pascal_voc_dataset.py:154-209)"""
        return voc.export_arrayrecord(split, self.pascal_root, dest_dir,
                                      image_size=self.image_size, limit=limit)

    def decode_files(self, basename: str) -> Tuple[np.ndarray, np.ndarray]:
        """The pair's files as float32 arrays: the JPEG (H, W, 3) and the
        label PNG (H, W, 1) from SegmentationClassAug when the tree has it,
        else SegmentationClass."""
        image = decode_image(os.path.join(self.pascal_root, "JPEGImages",
                                          basename + ".jpg"))
        mask_dir = "SegmentationClassAug" if os.path.isdir(
            os.path.join(self.pascal_root, "SegmentationClassAug")) \
            else "SegmentationClass"
        labels = decode_image(os.path.join(self.pascal_root, mask_dir,
                                           basename + ".png"), is_png=True)
        return image, labels

    def load_pair(self, basename: str) -> Tuple[np.ndarray, np.ndarray]:
        """(image (H, W, 3) float32 in [0, 1], labels (H, W, 1) float32) at
        image_size: bilinear for the image, nearest for the labels."""
        image, labels = self.decode(basename)
        labels = np.asarray(labels)
        if labels.ndim == 2:
            labels = labels[..., None]
        return (prepare_image(image, self.image_size, normalize=True),
                prepare_image(labels, self.image_size, normalize=False,
                              resize_method="nearest"))

    def batches(self, split: str, batch_size: int, shuffle: bool = False,
                seed: int = 0, augment: bool = False,
                prefetch: int = 2) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """Threaded prefetching batch iterator (the reference's tf.data
        pipeline role, reference pascal_voc_dataset.py:248-282): the split
        in order, or shuffled by ``np.random.default_rng(seed)``; full
        batches only (a ragged tail is dropped); with ``augment`` each pair
        through ``random_transform`` seeded with seed + its position, on
        the image truncated to uint8. One thread loads up to ``prefetch``
        batches ahead; an error there is raised here, and closing the
        iterator stops the thread."""
        names = list(self.get_basenames(split))
        if shuffle:
            rng = np.random.default_rng(seed)
            rng.shuffle(names)
        params = self.augmentation_params or DEFAULT_AUGMENTATION
        out_q: queue.Queue = queue.Queue(maxsize=prefetch)
        stop = threading.Event()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    out_q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    pass
            return False

        def producer():
            try:
                for start in range(0, len(names) - batch_size + 1, batch_size):
                    imgs, masks = [], []
                    for i, base in enumerate(names[start:start + batch_size]):
                        img, mask = self.load_pair(base)
                        if augment:
                            img8 = (img * 255).astype(np.uint8)
                            img8, mask = random_transform(
                                img8, mask[..., 0].astype(np.uint8),
                                target_shape=self.image_size,
                                seed=seed + start + i, **params)
                            img = img8.astype(np.float32) / 255.0
                            mask = mask[..., None].astype(np.float32)
                        imgs.append(img)
                        masks.append(mask)
                    if not put((np.stack(imgs), np.stack(masks))):
                        return
            except Exception as err:  # raised in the consumer's thread
                put(err)
                return
            put(None)

        thread = threading.Thread(target=producer, daemon=True, name="voc-prefetch")
        thread.start()
        try:
            while True:
                item = out_q.get()
                if item is None:
                    return
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
            thread.join()
