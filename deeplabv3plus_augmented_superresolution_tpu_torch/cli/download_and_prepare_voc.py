"""Download and prepare PASCAL VOC 2012 (port of the JAX repository's
``cli/download_and_prepare_voc.py``; the reference's
download_and_prepare_voc.py), with the same flags and steps: fetch the
archive into ``./data/dataset_root`` (an archive already there is kept),
unpack it unless the tree exists, optionally the Berkeley SBD masks, strip
the colormap, write the trainaug/valaug lists to
``./data/augmented_file_lists`` and export the train and val splits as .npz
array records (the TFRecord step's counterpart).

    python -m deeplabv3plus_augmented_superresolution_tpu_torch.cli.download_and_prepare_voc \\
        [--use_mirror] [--download_berkley] [--remove_cmap] [--generate_file_lists] \\
        [--generate_tf_records]

Host only: it never touches the card. Fetching needs the network; the
colormap and export steps need PIL.
"""

import argparse
import os
from typing import List, Optional

from ..data import voc


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--generate_tf_records",
                        help="Optionally generate packed array-record (.npz) files for the dataset",
                        action="store_true")
    parser.add_argument("--remove_cmap",
                        help="Remove colormap from masks, used in PASCAL VOC",
                        action="store_true")
    parser.add_argument("--use_mirror",
                        help="Download the dataset from a mirror site",
                        action="store_true")
    parser.add_argument("--pascal_root", help="Root directory of the PASCAL VOC dataset",
                        nargs="?", type=str,
                        default="./data/dataset_root/VOCdevkit/VOC2012",
                        const="./data/dataset_root/VOCdevkit/VOC2012")
    parser.add_argument("--download_berkley",
                        help="Download the augmented dataset provided by Berkley",
                        action="store_true")
    parser.add_argument("--generate_file_lists",
                        help="Generate trainaug/valaug file lists",
                        action="store_true")
    return parser


def main(argv: Optional[List[str]] = None) -> None:
    args = build_parser().parse_args(argv)

    dataset_url = voc.VOC_MIRROR_URL if args.use_mirror else voc.VOC_URL
    data_dir = os.path.join(os.getcwd(), "data")
    dataset_root = os.path.join(data_dir, "dataset_root")
    pascal_root = os.path.normpath(args.pascal_root)

    filepath = voc.download_dataset(dataset_url, dest_folder=dataset_root)
    voc.extract_file(filepath, dest_folder=dataset_root, is_extracted=pascal_root)

    if args.download_berkley:
        filepath = voc.download_dataset(voc.BERKELEY_URL, dataset_root)
        voc.extract_file(filepath, dest_folder=pascal_root,
                         is_extracted=os.path.join(pascal_root, "SegmentationClassAug"))

    if args.remove_cmap:
        voc.remove_gt_colormap(
            os.path.join(pascal_root, "SegmentationClass"),
            output_dir=os.path.join(pascal_root, "SegmentationClassRaw"))

    if args.generate_file_lists:
        n_train, n_val = voc.generate_dataset_files(
            pascal_root, os.path.join(data_dir, "berkley_file_lists"),
            os.path.join(data_dir, "augmented_file_lists"))
        print(f"Train images: {n_train}, Validation images: {n_val}")

    if args.generate_tf_records:
        records_dir = os.path.join(dataset_root, "ArrayRecords")
        for split in ("train", "val"):
            names = voc.get_basenames(split, pascal_root)
            print(f"Found {len(names)} {split} samples")
            out = voc.export_arrayrecord(split, pascal_root, records_dir)
            print(f"Exported {out}")
        print("Finished exporting")


if __name__ == "__main__":
    main()
