"""Convert a run's ``metrics.jsonl`` into a TensorBoard event file, the
port's counterpart of the JAX package's ``tools/export_tb_events.py``.

    python -m semanticsegmentationactivelearning_tpu_torch.tools.export_tb_events \\
        LOG_DIR [-o OUT_DIR]

The live path is the ``--tensorboard`` flag of the train and
active-learning CLIs; this tool back-fills runs logged without it, so
that TensorBoard shows them as it shows the reference's logs (reference
summaries: train.py:154-206, active_learning.py:425-427). It prints the
event file's path.
"""

import argparse
import os
import sys

from ..utils import tb_events


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m semanticsegmentationactivelearning_tpu_torch.tools."
             "export_tb_events")
    parser.add_argument("logdir", type=str,
                        help="Log directory containing metrics.jsonl "
                             "(or a direct path to a .jsonl file)")
    parser.add_argument("-o", "--output", type=str, default=None,
                        help="Output directory for the event file "
                             "(default: the log dir itself)")
    args = parser.parse_args(argv)

    path = args.logdir
    if os.path.isdir(path):
        path = os.path.join(path, "metrics.jsonl")
    out_dir = args.output or os.path.dirname(path) or "."
    print(tb_events.jsonl_to_events(path, out_dir))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except BrokenPipeError:  # stdout closed early (e.g. piped to head)
        os._exit(0)
