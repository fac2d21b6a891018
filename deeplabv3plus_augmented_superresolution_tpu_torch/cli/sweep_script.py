"""Hyper-parameter sweep runner (port of the JAX repository's
``cli/sweep_script.py``; reference sweep_script.py): one invocation
evaluates one configuration over the staged class subset
(``SR_single_class.run``) and appends its six IoUs and runtime to a CSV.
With wandb installed it reads wandb.config, so a wandb agent can drive it
from configs/sweep_configs/*.yaml as the reference does; without wandb it
runs from its flags.

  python -m deeplabv3plus_augmented_superresolution_tpu_torch.cli.sweep_script \\
      --lambda_tv 0.5 --num_samples 20
"""

import argparse
import csv
import os
import time
from typing import Dict, List, Optional

from . import SR_single_class
from ._common import add_device_arg, add_sr_args

CSV_FIELDS = ["lambda_tv", "lambda_L2", "lambda_L1", "learning_rate", "num_iter",
              "copy_dropout", "use_BTV", "optimizer", "amsgrad", "decay_rate",
              "decay_steps", "sgd_copies"]


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--num_aug", type=int, default=100)
    parser.add_argument("--num_samples", type=int, default=500)
    parser.add_argument("--class_id", type=int, default=8, choices=range(21))
    parser.add_argument("--mode", type=str, default="argmax",
                        choices=["slice_max", "slice", "argmax"])
    parser.add_argument("--backbone", type=str, default="xception",
                        choices=["mobilenet", "xception"])
    parser.add_argument("--use_validation", action="store_true", default=False)
    parser.add_argument("--th_factor", type=float, default=0.65)
    parser.add_argument("--angle_max", type=float, default=0.5)
    parser.add_argument("--output_csv", type=str, default=None)
    add_sr_args(parser)
    add_device_arg(parser)
    return parser


def run_config(args: argparse.Namespace,
               stencils: Optional[SR_single_class.StencilCache] = None
               ) -> Dict[str, float]:
    """Evaluate ONE configuration and append it to the sweep CSV; returns the
    metrics. stencils: a stencil cache kept across trials (sweep_agent)."""
    start = time.time()
    sweep_args = SR_single_class.build_parser().parse_args([])
    for key, value in vars(args).items():
        if hasattr(sweep_args, key):
            setattr(sweep_args, key, value)
    avg = SR_single_class.run(sweep_args, stencils)
    metrics = {
        "standard_iou_single": avg["standard_single"],
        "standard_iou_multiple": avg["standard_multiple"],
        "aug_iou_single": avg["aug_single"],
        "aug_iou_multiple": avg["aug_multiple"],
        "max_iou": avg["max"],
        "mean_iou": avg["mean"],
        "runtime_s": time.time() - start,
    }
    out_csv = args.output_csv or os.path.join(
        os.getcwd(), "experiments_data", f"sweep_{args.mode}_{args.num_samples}.csv")
    os.makedirs(os.path.dirname(out_csv), exist_ok=True)
    fields = CSV_FIELDS + list(metrics)
    write_header = not os.path.exists(out_csv)
    with open(out_csv, "a", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=fields)
        if write_header:
            writer.writeheader()
        row = {k: getattr(args, k) for k in fields if hasattr(args, k)}
        row.update(metrics)
        writer.writerow(row)
    print(f"Appended sweep row to {out_csv}")
    return metrics


def main(argv: Optional[List[str]] = None) -> Dict[str, float]:
    args = build_parser().parse_args(argv)
    try:
        import wandb
    except ImportError:
        wandb = None
    run = None
    if wandb is not None:
        run = wandb.init(config=vars(args))
        for key, value in dict(wandb.config).items():
            if hasattr(args, key):
                setattr(args, key, value)
    metrics = run_config(args)
    if run is not None:
        wandb.log(metrics)
        run.finish()
    return metrics


if __name__ == "__main__":
    main()
