"""Stage augmented LR masks to hdf5 (port of the JAX repository's
``cli/generate_augmented_copies.py``; reference generate_augmented_copies.py).

The same flags and output layout (data/superres_root/augmented_copies/
<backbone>_<mode>_<classid>_<numaug>[_validation]/<img>.hdf5), plus
``--device``. Each image's augmentation set comes from the seed and the
CRC-32 of its name (the same set in every process), or with --shared_tta
the seed's set for every image.

  python -m deeplabv3plus_augmented_superresolution_tpu_torch.cli.generate_augmented_copies \\
      --class_id 8

``main`` is the file side (the image list, the class filter, decode, hdf5);
its array core is ``pipeline.feature_maps.stage_feature_maps``.
"""

import argparse
from typing import List, Optional

from ..data.paths import filter_images_by_class, get_img_paths
from ..pipeline.feature_maps import compute_augmented_feature_maps
from ._common import SEED, add_device_arg, build_deeplab, data_paths


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--num_aug", type=int, default=100,
                        help="augmented copies per image (copy 0 is always the identity)")
    parser.add_argument("--num_samples", type=int, default=500,
                        help="cap on how many class-filtered images to process")
    parser.add_argument("--mode", type=str, default="argmax",
                        choices=["slice_max", "slice", "argmax"],
                        help="output-processing mode applied to each LR prediction")
    parser.add_argument("--angle_max", type=float, default=0.3,
                        help="rotation bound in radians; angles are uniform in +/- this")
    parser.add_argument("--shift_max", type=int, default=30,
                        help="translation bound in pixels; shifts are uniform in +/- this")
    parser.add_argument("--backbone", type=str, default="xception",
                        choices=["mobilenet", "xception"])
    parser.add_argument("--use_validation", action="store_true",
                        help="read the validation split instead of trainaug")
    parser.add_argument("--class_id", type=int, default=8, choices=range(21),
                        required=True,
                        help="PASCAL class to keep: only images containing it are used")
    parser.add_argument("--chunk_size", type=int, default=0,
                        help="model-forward chunk size (0 = single batch)")
    parser.add_argument("--shared_tta", action="store_true",
                        help="stage every image with the SAME augmentation set, so "
                             "that the solvers downstream reuse one Gram stencil")
    parser.add_argument("--weights_path", type=str, default=None)
    add_device_arg(parser)
    return parser


def main(argv: Optional[List[str]] = None) -> List[str]:
    """Stage every class-filtered image; returns the image names staged."""
    from tqdm import tqdm

    args = build_parser().parse_args(argv)
    paths = data_paths(args.use_validation, args.backbone, args.mode, args.class_id,
                       args.num_aug)
    model = build_deeplab(args.backbone, args.weights_path, device=args.device)
    image_size = model.cfg.input_shape[:2]
    image_paths = get_img_paths(paths["image_list"], paths["imgs_path"], is_png=False,
                                sort=True)
    filtered = filter_images_by_class(image_paths, filter_class_id=args.class_id,
                                      num_images=args.num_samples, image_size=image_size)
    print(f"Valid images: {len(filtered)} (Initial: {len(image_paths)})")
    print("Generating augmented copies...")
    names = []
    for image_path in tqdm(filtered):
        names.append(compute_augmented_feature_maps(
            model, image_path, filter_class_id=args.class_id, mode=args.mode,
            num_aug=args.num_aug, angle_max=args.angle_max, shift_max=args.shift_max,
            image_size=image_size, chunk_size=args.chunk_size,
            dest_folder=paths["augmented_copies_dir"], seed=SEED,
            shared_tta=args.shared_tta)[-1])
    return names


if __name__ == "__main__":
    main()
