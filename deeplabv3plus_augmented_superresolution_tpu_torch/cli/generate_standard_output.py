"""Standard baseline masks (port of the JAX repository's
``cli/generate_standard_output.py``; reference generate_standard_output.py):
the full model with its final upsample to the input size, argmax, every
pixel outside the class zeroed, one PNG per image under
data/superres_root/standard_output/<backbone>_<classid>[_validation]/.

  python -m deeplabv3plus_augmented_superresolution_tpu_torch.cli.generate_standard_output \\
      --class_id 8

``main`` is the file side (the image list, the class filter, decode, PNG);
its array core is ``standard_masks``.
"""

import argparse
import os
from typing import List, Optional

import torch

from ..data.io import load_image, save_img
from ..data.paths import filter_images_by_class, get_img_paths
from ..models.deeplab import DeepLab
from ._common import add_device_arg, build_deeplab, data_paths


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--num_samples", type=int, default=500)
    parser.add_argument("--backbone", type=str, default="xception",
                        choices=["mobilenet", "xception"])
    parser.add_argument("--use_validation", action="store_true")
    parser.add_argument("--class_id", type=int, default=8, choices=range(21),
                        required=True)
    parser.add_argument("--weights_path", type=str, default=None)
    add_device_arg(parser)
    return parser


@torch.no_grad()
def standard_masks(model: DeepLab, images: torch.Tensor, class_id: int) -> torch.Tensor:
    """(B, H, W, 3) images in [0, 1] on the model's device, through the full
    model (final upsample on) -> (B, H, W, 1) uint8 masks: class_id where
    the argmax is the class, else 0."""
    labels = torch.argmax(model(images), dim=-1, keepdim=True)
    return torch.where(labels == class_id, labels, 0).to(torch.uint8)


def main(argv: Optional[List[str]] = None) -> List[str]:
    """Write every class-filtered image's standard mask; returns the names."""
    from tqdm import tqdm

    args = build_parser().parse_args(argv)
    paths = data_paths(args.use_validation, args.backbone, class_id=args.class_id)
    model = build_deeplab(args.backbone, args.weights_path, device=args.device,
                          final_upsample=True)
    image_size = model.cfg.input_shape[:2]
    image_paths = get_img_paths(paths["image_list"], paths["imgs_path"], is_png=False,
                                sort=True)
    image_paths = filter_images_by_class(image_paths, filter_class_id=args.class_id,
                                         image_size=image_size)[:args.num_samples]
    print(f"Valid images: {len(image_paths)}")
    dest = paths["standard_output_dir"]
    os.makedirs(dest, exist_ok=True)
    print("Computing standard output images...")
    names = []
    for image_path in tqdm(image_paths):
        name = os.path.splitext(os.path.basename(image_path))[0]
        image = load_image(image_path, image_size=image_size, normalize=True)
        mask = standard_masks(model, torch.as_tensor(image, device=args.device)[None],
                              args.class_id)[0]
        save_img(os.path.join(dest, f"{name}.png"), mask.cpu().numpy(), scale=False)
        names.append(name)
    return names


if __name__ == "__main__":
    main()
