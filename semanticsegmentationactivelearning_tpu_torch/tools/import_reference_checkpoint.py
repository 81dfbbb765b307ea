"""Convert a reference TensorFlow checkpoint into a checkpoint of the
PyTorch port, the counterpart of the JAX package's
``tools/import_reference_checkpoint.py``.

    python -m semanticsegmentationactivelearning_tpu_torch.tools.import_reference_checkpoint \\
        --tf-checkpoint /ref/logs/model-42 -t cityscapes \\
        -p conf/enet_cityscapes_pretrain.json -o OUT_DIR \\
        [--modality-channels C] [--num-classes K] [--allow-partial]

The reference saves ``tf.train.Checkpoint(model, epoch, step,
optimizer)`` every epoch (reference: train.py:226-229, 352). This tool
reads one (``train/tf_import.py``, through TensorFlow), builds the
conf's model for the dataset's classes (or ``--num-classes``) and
``--modality-channels`` input planes, and writes a training checkpoint
``OUT_DIR/model-N.ckpt`` through the port's ``CheckpointManager``, with
the reference's epoch, step and save counter; the train, AL and
inference CLIs restore it with ``-c``. The optimizer starts fresh. It
refuses, with exit code 2, weights that have no place in that model (a
conf without ``softmax.multiscale`` against a checkpoint with the
multiscale heads, another class count) unless ``--allow-partial`` is
given; then they are dropped and the model keeps its own. It prints
the checkpoint's path.
"""

import argparse
import logging
import sys

from .. import datasets
from ..models import conf_model_kwargs, get_model
from ..train import checkpoint as ckpt
from ..train import config as cfg
from ..train import optim, steps, tf_import


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m semanticsegmentationactivelearning_tpu_torch.tools."
             "import_reference_checkpoint",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--tf-checkpoint", required=True,
                        help="TF checkpoint prefix (e.g. logs/model-42)"
                             " or a directory containing one")
    parser.add_argument("-t", "--dataset-type", required=True,
                        choices=["cityscapes", "freiburg", "vistas",
                                 "generic"],
                        help="Dataset the model was trained on "
                             "(sets num_classes)")
    parser.add_argument("-p", "--parameters", required=True,
                        help="Conf JSON matching the reference run "
                             "(network/input/hyperparams)")
    parser.add_argument("-o", "--output", required=True,
                        help="Output checkpoint directory")
    parser.add_argument("--modality-channels", type=int, default=3,
                        help="Input channels (3 unless multi-modal)")
    parser.add_argument("--num-classes", type=int, default=None,
                        help="Override the dataset's class count "
                             "(required for -t generic)")
    parser.add_argument("--allow-partial", action="store_true",
                        help="Proceed even if some converted weights "
                             "have no destination in the target model "
                             "(wrong conf/dataset otherwise aborts)")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    params = cfg.load_params(args.parameters)
    dataset = datasets.get_dataset(args.dataset_type)
    hparams = params["hyperparams"]
    num_classes = args.num_classes or getattr(dataset, "num_classes", None)
    if num_classes is None:
        parser.error("-t generic requires --num-classes")
    model_name = params["network"].get("model", "ENet")
    model = get_model(model_name, num_classes,
                      in_channels=args.modality_channels,
                      **conf_model_kwargs(model_name, hparams))

    converted = tf_import.convert_reference_checkpoint(args.tf_checkpoint)
    # refuse to write a checkpoint that silently dropped trained weights
    report = tf_import.merge_report(model.state_dict(), converted)
    dropped = report["missing"] + [k for k, _, _ in report["mismatched"]]
    if dropped:
        for name in dropped[:10]:
            logging.error("unmergeable converted weight: %s", name)
        if len(dropped) > 10:
            logging.error("... and %d more", len(dropped) - 10)
        if not args.allow_partial:
            parser.error(
                "%d of %d converted weights have no destination in "
                "the target model — the conf/-t/--num-classes/"
                "--modality-channels probably don't match the "
                "checkpoint. Re-run with --allow-partial to import anyway."
                % (len(dropped), len(dropped) + report["merged"]))
        logging.warning("--allow-partial: continuing; %d weights "
                        "keep fresh initialization", len(dropped))
    tf_import.load_into(model, converted)

    optimizer, scheduler = optim.make_optimizer(model.parameters(), hparams)
    state = steps.create_train_state(model, optimizer, scheduler)
    state.step = converted["step"]
    state.epoch = converted["epoch"]
    optim.set_schedule_step(scheduler, state.step)
    manager = ckpt.CheckpointManager(args.output)
    if "save_counter" in converted:
        manager.set_save_counter(converted["save_counter"] - 1)
    print(manager.save("model", state))
    manager.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
