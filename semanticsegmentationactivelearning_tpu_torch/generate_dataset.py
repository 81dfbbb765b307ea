"""Offline ETL CLI of the PyTorch port: dataset directory -> one
``.tfrecord`` file an example, the counterpart of the JAX package's
root ``generate_dataset.py`` (reference: generate_dataset.py:299-355).

    python -m semanticsegmentationactivelearning_tpu_torch.generate_dataset \\
        -d DATA_ROOT -t {cityscapes,freiburg,vistas,generic} -o OUT_DIR \\
        [-w WIDTH] [-a MAX_ASPECT] [--use-coarse] \\
        [--modalities MOD ...] [-i IMAGE_DIR -l LABEL_DIR]

The flags and the output layout are the root script's: one
``{file_id}.tfrecord`` an example under ``{output_dir}/{split}/``,
written through the port's copies of ``datasets/*`` and ``data/etl``,
so the records are byte for byte the root script's on the same tree.
Freiburg's ``--modalities`` (e.g. ``rgb nir_gray``) stores each extra
modality beside the image; the train, active-learning and inference
CLIs stack them after the RGB planes with ``-m``.
"""

import argparse
import logging
import os
import sys

from . import datasets
from .data import etl

logger = logging.getLogger(__name__)


def main(args):
    if args.dataset.lower() == "cityscapes":
        dataset = datasets.Cityscapes(args.use_coarse)
    elif args.dataset.lower() == "freiburg":
        dataset = datasets.Freiburg(args.modalities)
    elif args.dataset.lower() == "vistas":
        dataset = datasets.Vistas()
    elif args.dataset.lower() == "generic":
        dataset = datasets.Generic(args.image_dir, args.label_dir)
    else:
        raise ValueError("Dataset \"%s\" not supported." % args.dataset)

    if not os.path.exists(args.output_dir):
        if sys.stdin.isatty():
            sys.stdout.write("Directory \"%s\" does not exist. "
                             % args.output_dir)
            sys.stdout.write("Do you want to create it? [y/N] ")
            sys.stdout.flush()
            if sys.stdin.read(1).lower()[:1] != "y":
                return 0
        os.makedirs(args.output_dir, exist_ok=True)

    file_associations = dataset.file_associations(args.data_dir)
    for split in file_associations:
        split_path = os.path.join(args.output_dir, split)
        logger.info("Generating split %r (%d examples)", split,
                    len(file_associations[split]))
        etl.generate_split(file_associations[split], dataset.embedding,
                           split_path, width=args.width,
                           max_aspect=args.aspect, progress=True)
    return 0


def parse_arguments(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m semanticsegmentationactivelearning_tpu_torch."
             "generate_dataset")
    parser.add_argument("-d", "--data_root", type=str, dest="data_dir",
                        required=True,
                        help="Path to data set root directory.")
    parser.add_argument("-t", "--dataset", type=str, dest="dataset",
                        required=True,
                        help="Name of the dataset "
                             "{cityscapes,freiburg,vistas,generic}.")
    parser.add_argument("-o", "--output_dir", type=str, dest="output_dir",
                        required=True,
                        help="Path to where to store the records.")
    parser.add_argument("-w", "--width", type=int, default=-1, dest="width",
                        required=False, help="Width of packed examples.")
    parser.add_argument("-a", "--max-aspect-ratio", type=float, default=-1.0,
                        dest="aspect", required=False,
                        help="Maximum aspect ratio before center-cropping.")
    parser.add_argument("--use-coarse", action="store_true",
                        dest="use_coarse", default=False,
                        help="(Cityscapes) Use coarse annotation set.")
    parser.add_argument("--modalities", nargs="*", type=str,
                        dest="modalities", default=None,
                        help="(Freiburg) list of modalities to use.")
    parser.add_argument("-i", "--image-dir", type=str, dest="image_dir",
                        default=None,
                        help="(Generic) Image subdirectory under data root.")
    parser.add_argument("-l", "--label-dir", type=str, dest="label_dir",
                        default=None,
                        help="(Generic) Label subdirectory under data root.")
    return parser.parse_args(argv)


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    sys.exit(main(parse_arguments()))
