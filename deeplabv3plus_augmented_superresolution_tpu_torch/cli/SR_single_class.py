"""Augmented super-resolution over staged hdf5 stacks (port of the JAX
repository's ``cli/SR_single_class.py``; reference SR_single_class.py): load
each staged file, run aug, max and mean SR, score six IoUs against the
ground truth and the standard baseline, and print their averages.

  python -m deeplabv3plus_augmented_superresolution_tpu_torch.cli.SR_single_class \\
      --class_id 8 --no_validation

The flags replace the reference's constant block (SR_single_class.py:22-32)
with its defaults, plus ``--device``. ``run`` is the file side and the
importable entry of the sweeps; its array core is ``score_image``, with the
shared-set stencil of ``StencilCache``.
"""

import argparse
import os
import time
from typing import Dict, List, Optional, Set

import numpy as np
import torch

from ..data.io import load_image, load_sr_data
from ..data.paths import list_precomputed_data_paths
from ..metrics import compute_iou
from ..sr import SRConfig, precompute_gram_stencil
from ..sr.orchestrate import compute_sr
from ._common import (IMG_SIZE, SEED, add_device_arg, add_sr_args, data_paths,
                      make_sr_config, reads_one_stencil)

IOU_KEYS = ("standard_single", "standard_multiple", "aug_single", "aug_multiple",
            "max", "mean")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--num_aug", type=int, default=100)
    parser.add_argument("--num_samples", type=int, default=500)
    parser.add_argument("--class_id", type=int, default=8, choices=range(21))
    parser.add_argument("--mode", type=str, default="argmax",
                        choices=["slice_max", "slice", "argmax"])
    parser.add_argument("--backbone", type=str, default="xception",
                        choices=["mobilenet", "xception"])
    parser.add_argument("--use_validation", action="store_true", default=True)
    parser.add_argument("--no_validation", dest="use_validation", action="store_false")
    parser.add_argument("--th_factor", type=float, default=0.65)
    parser.add_argument("--angle_max", type=float, default=0.5,
                        help="static bound on generation angles (warp window sizing)")
    parser.add_argument("--save_slice_output", action="store_true")
    parser.add_argument("--save_final_sr_output", action="store_true")
    add_sr_args(parser)
    add_device_arg(parser)
    return parser


class StencilCache:
    """The Gram stencil of a staged augmentation set that repeats: when files
    share one (angles, shifts) (generate_augmented_copies --shared_tta), the
    solver's extraction is paid once, at the set's second occurrence in a
    run, and reused for every later file; a set seen once is solved with its
    own extraction (which costs less than a separate one). One stencil is
    kept at a time (66 MB at 512 px). Keep one cache across runs (the sweeps'
    trials) to reuse the stencil there too: it depends on the staged
    geometry and the operator, not on the lambdas."""

    def __init__(self):
        self._key = None
        self._coeffs: Optional[torch.Tensor] = None
        self.extractions = 0
        self.extraction_s = 0.0

    def lookup(self, tta_key: tuple, run_seen: Set[tuple], angles: torch.Tensor,
               shifts: torch.Tensor, sr_cfg: SRConfig) -> Optional[torch.Tensor]:
        """The stencil for a set that repeats within the run (run_seen holds
        the keys the run has seen) or was extracted earlier, else None."""
        key = tta_key + (sr_cfg.num_aug, sr_cfg.feature_size, sr_cfg.output_size,
                         sr_cfg.angle_max, sr_cfg.operator_impl, sr_cfg.warp_impl,
                         sr_cfg.solve_dtype, sr_cfg.gram_probing)
        if key == self._key:
            return self._coeffs
        if key not in run_seen:
            run_seen.add(key)
            return None
        self._key = self._coeffs = None
        start = time.perf_counter()
        coeffs = precompute_gram_stencil(angles, shifts, sr_cfg)
        if coeffs.is_cuda:
            torch.cuda.synchronize(coeffs.device)
        self.extraction_s += time.perf_counter() - start
        self.extractions += 1
        self._key, self._coeffs = key, coeffs
        return coeffs


def tta_key(angles: np.ndarray, shifts: np.ndarray) -> tuple:
    return (np.asarray(angles, np.float32).tobytes(),
            np.asarray(shifts, np.float32).tobytes())


def score_image(sr_cfg: SRConfig, class_masks: torch.Tensor,
                max_masks: Optional[torch.Tensor], angles: torch.Tensor,
                shifts: torch.Tensor, true_mask: np.ndarray, standard_mask: np.ndarray,
                *, class_id: int, th_factor: float,
                gram_coeffs: Optional[torch.Tensor] = None, filename: str = "",
                dest_folder: Optional[str] = None, save_slice_output: bool = False,
                save_final_sr_output: bool = False) -> Dict[str, float]:
    """Aug, max and mean SR of one image's normalized stacks (on the device
    of angles and shifts) and the six IoUs of ``IOU_KEYS``: the standard and
    the aug mask against the ground truth, each for the class alone and
    with the background, and the max and mean masks for the class."""
    results = {}
    for sr_type in ("aug", "max", "mean"):
        results[sr_type] = compute_sr(
            sr_cfg, class_masks, angles, shifts, filename, dest_folder=dest_folder,
            sr_type=sr_type, max_masks=max_masks,
            save_intermediate_output=save_slice_output,
            save_final_output=save_final_sr_output, class_id=class_id,
            th_factor=th_factor, dropout_generator=torch.Generator().manual_seed(SEED),
            gram_coeffs=gram_coeffs)
    return {
        "standard_single": compute_iou(true_mask, standard_mask, class_id=class_id),
        "standard_multiple": compute_iou(true_mask, standard_mask, class_id=class_id,
                                         include_bg=True),
        "aug_single": compute_iou(true_mask, results["aug"], class_id=class_id),
        "aug_multiple": compute_iou(true_mask, results["aug"], class_id=class_id,
                                    include_bg=True),
        "max": compute_iou(true_mask, results["max"], class_id=class_id),
        "mean": compute_iou(true_mask, results["mean"], class_id=class_id),
    }


def average(scores: List[Dict[str, float]]) -> Dict[str, float]:
    """The mean of each IoU over the images, printed as the reference does."""
    avg = {k: float(np.mean([s[k] for s in scores])) for k in IOU_KEYS}
    print(f"Avg. Standard IoUs (No bg): {avg['standard_single']},  "
          f"Avg. Augmented SR IoUs (No bg): {avg['aug_single']}")
    print(f"Avg. Standard IoUs (with bg): {avg['standard_multiple']},  "
          f"Avg. Augmented SR IoUs (with bg): {avg['aug_multiple']}")
    print(f"Avg. Max SR IoUs: {avg['max']}, Avg. Mean SR IoUs: {avg['mean']}")
    return avg


def run(args: argparse.Namespace, stencils: Optional[StencilCache] = None
        ) -> Dict[str, float]:
    """Evaluate the staged class subset with args' hyper-parameters; returns
    the six average IoUs. stencils: a cache kept across runs (the sweeps)."""
    from tqdm import tqdm

    paths = data_paths(args.use_validation, args.backbone, args.mode, args.class_id,
                       args.num_aug)
    path_list = list_precomputed_data_paths(paths["augmented_copies_dir"], sort=True)
    path_list = path_list[:args.num_samples] if args.num_samples else path_list
    if not path_list:
        raise SystemExit(
            f"No precomputed hdf5 files under {paths['augmented_copies_dir']}: run "
            "generate_augmented_copies first")
    device = torch.device(args.device)
    stencils = stencils if stencils is not None else StencilCache()
    run_seen: Set[tuple] = set()
    scores = []
    for filepath in tqdm(path_list):
        try:
            class_masks, max_masks, angles, shifts, filename = load_sr_data(
                filepath, num_aug=args.num_aug, global_normalize=True, device=device)
        except (OSError, KeyError, ValueError):
            print(f"File: {filepath} is invalid, skipping...")
            continue
        true_mask = load_image(
            os.path.join(paths["pascal_root"], "SegmentationClassAug", f"{filename}.png"),
            image_size=IMG_SIZE, normalize=False, is_png=True, resize_method="nearest")
        standard_mask = load_image(
            os.path.join(paths["standard_output_dir"], f"{filename}.png"),
            image_size=IMG_SIZE, normalize=False, is_png=True, resize_method="nearest")
        # The LR size comes from the staged masks (128 for Xception OS16, 64
        # for MobileNetV2 OS8).
        sr_cfg = make_sr_config(args, num_aug=args.num_aug,
                                feature_size=tuple(class_masks.shape[1:3]),
                                output_size=IMG_SIZE)
        key = tta_key(angles, shifts)
        angles = torch.as_tensor(angles, device=device)
        shifts = torch.as_tensor(shifts, device=device)
        gram_coeffs = (stencils.lookup(key, run_seen, angles, shifts, sr_cfg)
                       if reads_one_stencil(sr_cfg) else None)
        scores.append(score_image(
            sr_cfg, class_masks, max_masks, angles, shifts, true_mask, standard_mask,
            class_id=args.class_id, th_factor=args.th_factor, gram_coeffs=gram_coeffs,
            filename=filename, dest_folder=paths["superres_output_dir"],
            save_slice_output=args.save_slice_output,
            save_final_sr_output=args.save_final_sr_output))
    return average(scores)


def main(argv: Optional[List[str]] = None) -> Dict[str, float]:
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
