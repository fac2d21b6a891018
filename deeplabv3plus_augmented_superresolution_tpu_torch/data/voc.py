"""PASCAL VOC 2012 acquisition and preparation (port of the JAX package's
``data/voc.py``; the reference's download_and_prepare_voc.py,
data_scripts/data_utils.py, remove_gt_colormap.py and
generate_dataset_files.py).

Dataset download (official, mirror, Berkeley SBD), idempotent extraction,
colormap stripping, the trainaug/valaug list union and the .npz
array-record export that stands in for the reference's TFRecords. These run
on the host only. PIL is imported inside the two functions that decode or
encode image files, so the module imports where PIL is not installed.
"""

import os
import sys
import tarfile
import zipfile
from typing import Optional, Sequence, Tuple

import numpy as np

VOC_URL = "http://host.robots.ox.ac.uk/pascal/VOC/voc2012/VOCtrainval_11-May-2012.tar"
VOC_MIRROR_URL = "http://pjreddie.com/media/files/VOCtrainval_11-May-2012.tar"
BERKELEY_URL = "https://www.dropbox.com/s/oeu149j8qtbs1x0/SegmentationClassAug.zip?dl=1"

# The 21 VOC classes; 255 is the ignore label (reference data/pascal_classes.txt).
PASCAL_CLASSES = [
    "background", "aeroplane", "bicycle", "bird", "boat", "bottle", "bus",
    "car", "cat", "chair", "cow", "diningtable", "dog", "horse", "motorbike",
    "person", "pottedplant", "sheep", "sofa", "train", "tvmonitor",
]


def voc_colormap(num_colors: int = 256) -> np.ndarray:
    """The VOC bit-twiddled palette (reference pascal_voc_dataset.py:51-76)."""
    cmap = np.zeros((num_colors, 3), dtype=np.uint8)
    for i in range(num_colors):
        r = g = b = 0
        c = i
        for j in range(8):
            r |= ((c >> 0) & 1) << (7 - j)
            g |= ((c >> 1) & 1) << (7 - j)
            b |= ((c >> 2) & 1) << (7 - j)
            c >>= 3
        cmap[i] = (r, g, b)
    return cmap


def download_dataset(dataset_url: str, dest_folder: str) -> str:
    """Fetch an archive into dest_folder; a file already on disk is kept as-is.

    Returns the local archive path. (Role of reference data_utils.py:13-49.)
    """
    import urllib.request

    os.makedirs(dest_folder, exist_ok=True)
    # Archive name = URL basename truncated after its .tar/.zip suffix — the
    # Berkeley SBD link carries a ?dl=1 query string after the extension.
    tail = dataset_url.rsplit("/", 1)[-1]
    for ext in (".zip", ".tar"):
        cut = tail.find(ext)
        if cut != -1:
            tail = tail[: cut + len(ext)]
            break
    local_path = os.path.join(dest_folder, tail)
    if os.path.exists(local_path):
        print(f"[voc] {tail}: already on disk, not re-fetching")
        return local_path

    def _report(blocks_done, block_size, total_bytes):
        done_mb = blocks_done * block_size / 2**20
        if total_bytes > 0:
            pct = min(100.0, 100.0 * blocks_done * block_size / total_bytes)
            sys.stdout.write(f"\r[voc] fetching {tail}: {pct:5.1f}%")
        else:
            sys.stdout.write(f"\r[voc] fetching {tail}: {done_mb:.0f} MiB")
        sys.stdout.flush()

    urllib.request.urlretrieve(dataset_url, local_path, _report)
    print(f"\n[voc] fetched {tail}")
    return local_path


def extract_file(filepath: str, dest_folder: str,
                 is_extracted: Optional[str] = None) -> None:
    """Unpack a .tar/.zip archive unless the sentinel path already exists.

    `is_extracted` names a path whose presence marks a previous successful
    extraction (e.g. the VOCdevkit dir). (Role of reference data_utils.py:52-83.)
    """
    if is_extracted and os.path.exists(is_extracted):
        print(f"[voc] {os.path.basename(filepath)}: already unpacked, skipping")
        return
    openers = {".zip": zipfile.ZipFile, ".tar": tarfile.open}
    opener = openers.get(os.path.splitext(filepath)[1])
    if opener is None:
        raise ValueError(f"cannot unpack {filepath!r}: need a .tar or .zip archive")
    with opener(filepath) as archive:
        archive.extractall(dest_folder)


def remove_gt_colormap(seg_folder: str, output_dir: str) -> int:
    """Strip the VOC palette from GT PNGs to raw label PNGs
    (reference data_scripts/remove_gt_colormap.py:29-61)."""
    from PIL import Image

    os.makedirs(output_dir, exist_ok=True)
    count = 0
    for name in sorted(os.listdir(seg_folder)):
        if not name.endswith(".png"):
            continue
        img = Image.open(os.path.join(seg_folder, name))
        raw = np.asarray(img)  # palette PNG: values are already label indices
        Image.fromarray(raw.astype(np.uint8), mode="L").save(
            os.path.join(output_dir, name))
        count += 1
    return count


def generate_dataset_files(pascal_root: str, berkeley_lists_dir: str,
                           output_folder: str) -> Tuple[int, int]:
    """trainaug/valaug list union (reference generate_dataset_files.py:38-61):
    validation = pascal val; train = (pascal ∪ berkeley) − validation."""

    def read_list(path):
        with open(path) as f:
            return {line.rstrip() for line in f if line.strip()}

    seg_dir = os.path.join(pascal_root, "ImageSets", "Segmentation")
    pascal_train = read_list(os.path.join(seg_dir, "train.txt"))
    pascal_val = read_list(os.path.join(seg_dir, "val.txt"))
    berkeley_train = read_list(os.path.join(berkeley_lists_dir, "train.txt"))
    berkeley_val = read_list(os.path.join(berkeley_lists_dir, "val.txt"))

    everything = pascal_train | pascal_val | berkeley_train | berkeley_val
    validation = pascal_val
    train = everything - validation

    os.makedirs(output_folder, exist_ok=True)
    with open(os.path.join(output_folder, "trainaug.txt"), "w") as f:
        f.write("\n".join(sorted(train)))
    with open(os.path.join(output_folder, "valaug.txt"), "w") as f:
        f.write("\n".join(sorted(validation)))
    return len(train), len(validation)


def get_basenames(split: str, pascal_root: str) -> Sequence[str]:
    """Image ids of a segmentation split (reference pascal_voc_dataset.py:113)."""
    path = os.path.join(pascal_root, "ImageSets", "Segmentation", f"{split}.txt")
    with open(path) as f:
        return [line.rstrip() for line in f if line.strip()]


def export_arrayrecord(split: str, pascal_root: str, dest_dir: str,
                       image_size=(512, 512), limit: Optional[int] = None) -> str:
    """Pack a split's (image, mask) pairs into one .npz for fast host loading
    (replaces the reference's TFRecord export, pascal_voc_dataset.py:154-209)."""
    from .io import load_image

    basenames = get_basenames(split, pascal_root)
    if limit:
        basenames = basenames[:limit]
    images, masks = [], []
    for base in basenames:
        img = load_image(os.path.join(pascal_root, "JPEGImages", base + ".jpg"),
                         image_size=image_size, normalize=False)
        mask = load_image(os.path.join(pascal_root, "SegmentationClass", base + ".png"),
                          image_size=image_size, normalize=False, is_png=True,
                          resize_method="nearest")
        images.append(img.astype(np.uint8))
        masks.append(mask.astype(np.uint8))
    os.makedirs(dest_dir, exist_ok=True)
    out = os.path.join(dest_dir, f"segmentation_{split}.npz")
    np.savez_compressed(out, images=np.stack(images), masks=np.stack(masks),
                        basenames=np.asarray(basenames))
    return out
