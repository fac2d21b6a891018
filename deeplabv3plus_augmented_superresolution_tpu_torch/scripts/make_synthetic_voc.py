"""Materialise synthetic scenes as a VOC-shaped tree on disk.

Port of the JAX repository's ``scripts/make_synthetic_voc.py``. The
dataset-reading CLIs (check_robustness, validate_parity, run_asr --gt_dir,
train --data voc) follow the reference's directory contract (JPEGImages/ +
SegmentationClassAug/ + augmented_file_lists/*.txt, reference
superres_utils.py:20-38). Without the PASCAL tree, this writes scenes of
``data/synthetic.py`` (optionally the hard recipe) into that layout: the
same seed writes the JAX script's scenes.

    python -m deeplabv3plus_augmented_superresolution_tpu_torch.scripts.make_synthetic_voc \\
        --root synvoc --n 48 --hard

``train --data voc`` reads ``<pascal_root>/ImageSets/Segmentation/<split>.txt``,
not the list written here (ROADMAP F9): copy ``trainaug.txt`` there. Host
only (numpy and PIL); nothing runs on the card.
"""

import argparse
import os
from typing import List, Optional

import numpy as np

from ..data.synthetic import synthetic_scene


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", required=True,
                    help="workdir root; the tree lands at "
                         "<root>/data/dataset_root/VOCdevkit/VOC2012")
    ap.add_argument("--n", type=int, default=48)
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--class_ids", type=int, nargs="+", default=[8, 12])
    ap.add_argument("--hard", action="store_true")
    ap.add_argument("--seed", type=int, default=4321)
    ap.add_argument("--validation", action="store_true",
                    help="also list the images in valaug.txt")
    return ap


def main(argv: Optional[List[str]] = None) -> List[str]:
    """Writes the tree; returns the scenes' names."""
    args = build_parser().parse_args(argv)
    from PIL import Image

    voc = os.path.join(args.root, "data", "dataset_root", "VOCdevkit", "VOC2012")
    img_dir = os.path.join(voc, "JPEGImages")
    gt_dir = os.path.join(voc, "SegmentationClassAug")
    lists = os.path.join(args.root, "data", "augmented_file_lists")
    for d in (img_dir, gt_dir, lists):
        os.makedirs(d, exist_ok=True)

    rng = np.random.default_rng(args.seed)
    names = []
    for i in range(args.n):
        img, lab = synthetic_scene(rng, (args.size, args.size),
                                   class_ids=tuple(args.class_ids), hard=args.hard)
        name = f"synth_{args.seed}_{i:04d}"
        Image.fromarray((img * 255).astype(np.uint8)).save(
            os.path.join(img_dir, f"{name}.jpg"), quality=95)
        Image.fromarray(lab.astype(np.uint8), mode="L").save(
            os.path.join(gt_dir, f"{name}.png"))
        names.append(name)
    with open(os.path.join(lists, "trainaug.txt"), "w") as f:
        f.write("\n".join(names))
    if args.validation:
        with open(os.path.join(lists, "valaug.txt"), "w") as f:
            f.write("\n".join(names))
    print(f"{args.n} scenes ({'hard' if args.hard else 'easy'}, seed {args.seed}) -> {voc}")
    return names


if __name__ == "__main__":
    main()
