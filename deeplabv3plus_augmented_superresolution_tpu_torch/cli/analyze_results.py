"""Analysis of experiment CSVs (port of the JAX repository's
``cli/analyze_results.py``; the reference's plot_cvs.ipynb): robustness
heat/line plots, threshold curves, sweep scatter, per-class bars.

Reads whatever CSVs exist under experiments_data/ and writes PNGs next to
them plus a text summary to stdout.

    python -m deeplabv3plus_augmented_superresolution_tpu_torch.cli.analyze_results \
        [--experiments_dir DIR] [--no_plots]

Host only: it never touches the card. It needs pandas, and matplotlib for
the plots; both are imported inside ``main``.
"""

import argparse
import glob
import os
from typing import List, Optional


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--experiments_dir", type=str,
                        default=os.path.join(os.getcwd(), "experiments_data"))
    parser.add_argument("--no_plots", action="store_true",
                        help="text summaries only")
    return parser


def main(argv: Optional[List[str]] = None) -> None:
    args = build_parser().parse_args(argv)
    import pandas as pd

    if not args.no_plots:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

    found = False

    for path in sorted(glob.glob(os.path.join(args.experiments_dir, "th_*.csv"))):
        found = True
        df = pd.read_csv(path)
        best = df.iloc[df["avg_iou"].idxmax()]
        print(f"[threshold] {os.path.basename(path)}: best th_factor="
              f"{best.th_factor} IoU={best.avg_iou:.4f}")
        if not args.no_plots:
            ax = df.plot(x="th_factor", y="avg_iou", marker="o", legend=False)
            ax.set_ylabel("avg IoU")
            ax.figure.savefig(path.replace(".csv", ".png"), dpi=120,
                              bbox_inches="tight")

    for path in sorted(glob.glob(os.path.join(args.experiments_dir,
                                              "robustness_*.csv"))):
        found = True
        df = pd.read_csv(path)
        ident = df[(df.Angle == 0) & (df.Shift_x == 0) & (df.Shift_y == 0)]
        print(f"[robustness] {os.path.basename(path)}: identity mIoU="
              f"{float(ident.Mean_IoU.iloc[0]) if len(ident) else float('nan'):.4f} "
              f"range=[{df.Mean_IoU.min():.4f}, {df.Mean_IoU.max():.4f}]")
        if not args.no_plots:
            zero_shift = df[(df.Shift_x == 0) & (df.Shift_y == 0)]
            fig, axes = plt.subplots(1, 2, figsize=(11, 4))
            zero_shift.plot(x="Angle", y="Mean_IoU", ax=axes[0], legend=False,
                            title="mIoU vs rotation (no shift)")
            zero_angle = df[df.Angle == 0]
            if len(zero_angle):
                pivot = zero_angle.pivot_table(index="Shift_y",
                                               columns="Shift_x",
                                               values="Mean_IoU")
                im = axes[1].imshow(pivot.values, origin="lower",
                                    extent=[pivot.columns.min(), pivot.columns.max(),
                                            pivot.index.min(), pivot.index.max()])
                axes[1].set_title("mIoU vs shift (no rotation)")
                fig.colorbar(im, ax=axes[1])
            fig.savefig(path.replace(".csv", ".png"), dpi=120,
                        bbox_inches="tight")

    for path in sorted(glob.glob(os.path.join(args.experiments_dir,
                                              "sweep_*.csv"))):
        found = True
        df = pd.read_csv(path)
        if "aug_iou_single" in df:
            best = df.iloc[df["aug_iou_single"].idxmax()]
            print(f"[sweep] {os.path.basename(path)}: {len(df)} runs, best "
                  f"aug_iou_single={best.aug_iou_single:.4f} "
                  f"(lambda_tv={best.get('lambda_tv')}, "
                  f"lambda_L2={best.get('lambda_L2')}, "
                  f"lambda_L1={best.get('lambda_L1')})")
            if not args.no_plots and {"lambda_tv", "lambda_L2"} <= set(df):
                ax = df.plot.scatter(x="lambda_tv", y="lambda_L2",
                                     c="aug_iou_single", colormap="viridis")
                ax.figure.savefig(path.replace(".csv", "_lambda_space.png"),
                                  dpi=120, bbox_inches="tight")

    # Final per-class validation CSVs (the reference's plot_cvs.ipynb last
    # cells: per-class IoU bars + ASR-standard deltas). Schema is the
    # reference final_validations CSVs': one "Class N" row per class with
    # aug/standard/max/mean IoU columns (argmax_validation_final.csv:1).
    for path in sorted(glob.glob(os.path.join(args.experiments_dir,
                                              "*validation*.csv"))):
        found = True
        df = pd.read_csv(path)
        iou_cols = [c for c in ("aug_iou_single", "standard_iou_single",
                                "aug_iou_multiple", "standard_iou_multiple",
                                "max_iou", "mean_iou") if c in df]
        if "Name" not in df or not iou_cols:
            continue
        name = os.path.basename(path)
        means = df[iou_cols].mean()
        print(f"[validation] {name}: " +
              " ".join(f"{c}={means[c]:.4f}" for c in iou_cols))
        if {"aug_iou_single", "standard_iou_single"} <= set(df):
            delta = (df["aug_iou_single"] - df["standard_iou_single"]).mean()
            print(f"[validation] {name}: mean ASR-standard delta = {delta:+.4f}")
        if not args.no_plots:
            fig, axes = plt.subplots(
                2 if {"aug_iou_single", "standard_iou_single"} <= set(df) else 1,
                1, figsize=(12, 8), squeeze=False)
            x = range(len(df))
            width = 0.8 / len(iou_cols)
            for i, c in enumerate(iou_cols):
                axes[0][0].bar([xi + i * width for xi in x], df[c],
                               width=width, label=c)
            axes[0][0].set_xticks([xi + 0.4 for xi in x])
            axes[0][0].set_xticklabels(df["Name"], rotation=45, ha="right")
            axes[0][0].set_ylabel("IoU")
            axes[0][0].set_title(f"per-class IoU — {name}")
            axes[0][0].legend(fontsize=7)
            if len(axes) > 1:
                d = df["aug_iou_single"] - df["standard_iou_single"]
                axes[1][0].bar(x, d, color=["#2a7" if v >= 0 else "#c33"
                                            for v in d])
                axes[1][0].set_xticks(list(x))
                axes[1][0].set_xticklabels(df["Name"], rotation=45, ha="right")
                axes[1][0].set_ylabel("ASR - standard IoU")
                axes[1][0].axhline(0, color="k", lw=0.5)
            fig.tight_layout()
            fig.savefig(path.replace(".csv", "_per_class.png"), dpi=120,
                        bbox_inches="tight")

    if not found:
        print(f"No experiment CSVs found under {args.experiments_dir}; run "
              "threshold_tests.py / check_robustness.py / sweep_script.py first.")


if __name__ == "__main__":
    main()
