"""Shared CLI plumbing (port of the JAX repository's ``cli/_common.py``): the
reference's directory contract, the DeepLabV3+ model of the CLIs, the SR
config with its flags, the seed and the device flag.

The JAX CLIs' TPU environment defaults are not ported (ROADMAP ground rules).
"""

import argparse
import os
from typing import Optional

from ..data.paths import augmented_copies_dir, standard_output_dir
from ..models import DeepLabConfig, build_model, default_weights_path
from ..models.deeplab import DeepLab
from ..sr import OptimizerConfig, SRConfig

SEED = 1234
IMG_SIZE = (512, 512)


def data_paths(use_validation: bool = False, backbone: str = "xception",
               mode: str = "argmax", class_id: int = 8, num_aug: int = 100):
    """The reference's directory contract under ``./data`` of the working
    directory (generate_augmented_copies.py:57-64, SR_single_class.py:34-47)."""
    data_dir = os.path.join(os.getcwd(), "data")
    pascal_root = os.path.join(data_dir, "dataset_root", "VOCdevkit", "VOC2012")
    superres_root = os.path.join(data_dir, "superres_root")
    suffix = "_validation" if use_validation else ""
    return {
        "data_dir": data_dir,
        "pascal_root": pascal_root,
        "imgs_path": os.path.join(pascal_root, "JPEGImages"),
        "superres_root": superres_root,
        "augmented_copies_dir": augmented_copies_dir(
            superres_root, backbone, mode, class_id, num_aug, use_validation),
        "standard_output_dir": standard_output_dir(
            superres_root, backbone, class_id, use_validation),
        "superres_output_dir": os.path.join(superres_root, f"superres_output{suffix}"),
        "image_list": os.path.join(
            data_dir, "augmented_file_lists",
            f"{'valaug' if use_validation else 'trainaug'}.txt"),
    }


def build_deeplab(backbone: str = "xception", weights_path: Optional[str] = None,
                  *, device, final_upsample: bool = False) -> DeepLab:
    """The CLIs' model (Xception OS16 or MobileNetV2 OS8, bf16, 512 px), with
    the bonlime checkpoint when a local .h5 exists, else random init (seed
    0). final_upsample: the full model with the x4 (x8) upsample to the input
    size, as the standard masks and the robustness study use; without it the
    network's low-resolution logits, as ASR serves them."""
    cfg = DeepLabConfig(input_shape=IMG_SIZE + (3,), classes=21, os=16,
                        backbone=backbone, final_upsample=final_upsample,
                        compute_dtype="bfloat16")
    path = weights_path or default_weights_path(backbone)
    if not os.path.exists(path):
        print(f"WARNING: pretrained weights not found at {path}; running with "
              "random initialization (masks will be meaningless)")
        path = None
    return build_model(cfg, seed=0, weights_path=path, device=device)


def feature_size_of(cfg: DeepLabConfig):
    """The LR mask size of a model without its final upsample: 1/4 of the
    input for Xception OS16 (the decoder), 1/8 for MobileNetV2 (OS8)."""
    factor = 8 if cfg.backbone == "mobilenet" else 4
    return tuple(d // factor for d in cfg.input_shape[:2])


def make_sr_config(args=None, num_aug: int = 100, feature_size=None,
                   output_size=IMG_SIZE, **overrides) -> SRConfig:
    """SRConfig from CLI args with the reference's defaults
    (SR_single_class.py:50-64); overrides win over args. feature_size
    defaults to the LR size of the 512-px Xception model."""
    if feature_size is None:
        feature_size = feature_size_of(DeepLabConfig(input_shape=IMG_SIZE + (3,)))
    hp = {
        "lambda_df": 1.0, "lambda_tv": 0.3, "lambda_L2": 0.7, "lambda_L1": 0.0,
        "num_iter": 300, "optimizer": "adam", "learning_rate": 1e-3,
        "amsgrad": True, "lr_scheduler": True, "decay_steps": 60,
        "decay_rate": 0.3, "copy_dropout": 0.0, "use_BTV": False,
        "angle_max": 0.5, "sgd_copies": 0, "solver_impl": "gram",
        "operator_impl": "fused", "warp_impl": "shear",
        "gram_probing": "aliased",
    }
    if args is not None:
        for key in hp:
            if hasattr(args, key):
                hp[key] = getattr(args, key)
    hp.update(overrides)
    opt = OptimizerConfig(
        name=hp["optimizer"], learning_rate=hp["learning_rate"],
        amsgrad=hp["amsgrad"], lr_scheduler=hp["lr_scheduler"],
        decay_steps=hp["decay_steps"], decay_rate=hp["decay_rate"])
    return SRConfig(
        lambda_df=hp["lambda_df"], lambda_tv=hp["lambda_tv"],
        lambda_L2=hp["lambda_L2"], lambda_L1=hp["lambda_L1"],
        num_iter=hp["num_iter"], num_aug=num_aug,
        feature_size=tuple(feature_size), output_size=tuple(output_size),
        use_BTV=hp["use_BTV"], copy_dropout=hp["copy_dropout"],
        angle_max=max(float(hp["angle_max"]), 1e-3),
        sgd_copies=hp["sgd_copies"], solver_impl=hp["solver_impl"],
        operator_impl=hp["operator_impl"], warp_impl=hp["warp_impl"],
        gram_probing=hp["gram_probing"], optimizer=opt)


def reads_one_stencil(sr_cfg: SRConfig) -> bool:
    """Whether the aug solve can read one precomputed Gram stencil for every
    solve of a set: the gram or cg solver, no copy dropout (which changes the
    system per solve), no copy minibatches (which solve directly)."""
    return (sr_cfg.solver_impl in ("gram", "cg") and sr_cfg.copy_dropout == 0.0
            and not 0 < sr_cfg.sgd_copies < sr_cfg.num_aug)


def add_sr_args(parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
    parser.add_argument("--lambda_df", type=float, default=1.0)
    parser.add_argument("--lambda_tv", type=float, default=0.3)
    parser.add_argument("--lambda_L2", type=float, default=0.7)
    parser.add_argument("--lambda_L1", type=float, default=0.0)
    parser.add_argument("--num_iter", type=int, default=300)
    parser.add_argument("--optimizer", type=str, default="adam",
                        choices=["adam", "adamax", "adagrad", "adadelta", "sgd"])
    parser.add_argument("--learning_rate", type=float, default=1e-3)
    parser.add_argument("--amsgrad", action="store_true", default=True)
    parser.add_argument("--lr_scheduler", action="store_true", default=True)
    parser.add_argument("--decay_steps", type=int, default=60)
    parser.add_argument("--decay_rate", type=float, default=0.3)
    parser.add_argument("--copy_dropout", type=float, default=0.0)
    parser.add_argument("--use_BTV", action="store_true")
    parser.add_argument("--sgd_copies", type=int, default=0)
    parser.add_argument("--solver_impl", type=str, default="gram",
                        choices=["gram", "cg", "direct"])
    parser.add_argument("--operator_impl", type=str, default="fused",
                        choices=["fused", "staged"])
    parser.add_argument("--warp_impl", type=str, default="shear",
                        choices=["shear", "gather"])
    parser.add_argument("--gram_probing", type=str, default="aliased",
                        choices=["aliased", "dense"])
    return parser


def add_device_arg(parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to run on (the CUDA kernel needs "
                             "'cuda'; 'cpu' runs the plain versions)")
    return parser
