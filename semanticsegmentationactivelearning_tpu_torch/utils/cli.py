"""Shared CLI plumbing of the port's entry points, the counterpart of
``semanticsegmentationactivelearning_tpu/utils/cli.py``.

The reference's argparse tree: dataset subcommands {cityscapes,
freiburg, vistas} sharing the required ``-d/-l/-p`` and the optional
``-c`` arguments (reference: train.py:387-479), plus ``--device
{cuda,cpu}`` (default ``cuda``, which raises without a card), logging
set-up, the per-step scalar buffer and the JSONL metrics writer.
``maybe_trace`` records a ``torch.profiler`` trace. The JAX CLI's
TPU-relay workarounds (``respect_platform_env``,
``enable_compilation_cache``, ``dispatch_grouped_train``) are not
ported (ROADMAP.md "Not to port").
"""

from __future__ import annotations

import argparse
import contextlib
import json
import logging
import logging.config
import os
import sys
import time
from typing import Optional

import numpy as np
import torch

from .. import datasets
from ..parallel import distributed


def setup_logging(config_path: str = "util/logging.json") -> None:
    """dictConfig logging like every reference CLI (train.py:483-487)."""
    if os.path.exists(config_path):
        with open(config_path) as fp:
            logging.config.dictConfig(json.load(fp))
    else:
        logging.basicConfig(
            level=logging.INFO,
            format="[%(levelname)s] %(asctime)s --- %(name)s//%(module)s"
                   " : %(message)s")


class HelpfulParser(argparse.ArgumentParser):
    """Prints help instead of the usage string on error
    (reference: train.py:381-385)."""

    def error(self, message):
        self.print_help()
        self.exit(2, "error: %s\n" % message)


def build_dataset_parser(prog: str, extra_optional=None,
                         params_required: bool = True):
    """The shared subcommand parser tree.

    :param extra_optional: callback(parser) adding script-specific flags
    """
    req_parser = argparse.ArgumentParser(add_help=False)
    req_group = req_parser.add_argument_group(title="Required arguments")
    req_group.add_argument("-d", "--data-dir", type=str, dest="data_dir",
                           required=True,
                           help="Path to dataset root directory")
    req_group.add_argument("-l", "--log-dir", type=str, dest="log_dir",
                           required=True, metavar="LOGDIR",
                           help="Logdirectory for the session.")
    req_group.add_argument("-p", "--parameters", type=str, dest="params",
                           required=params_required,
                           default="conf/default_params.json",
                           metavar="PARAMS",
                           help="Path to parameter configuration file, "
                                "see conf subdirectory.")

    opt_parser = argparse.ArgumentParser(add_help=False)
    opt_parser.add_argument("-c", "--checkpoint", type=str,
                            dest="checkpoint", required=False,
                            metavar="CHECKPOINT",
                            help="Path to pretrained checkpoint "
                                 "directory or model (port or JAX).")
    opt_parser.add_argument("--seed", type=int, dest="seed", default=0,
                            required=False,
                            help="PRNG seed for init/augmentation.")
    opt_parser.add_argument("--trace", type=str, dest="trace",
                            default=None, required=False,
                            metavar="TRACE_DIR",
                            help="Write a torch.profiler trace of the hot "
                                 "loop to this directory (a Chrome trace).")
    opt_parser.add_argument("--tensorboard", action="store_true",
                            dest="tensorboard", default=False,
                            help="Also mirror metrics into a real "
                                 "tfevents file under the log dir "
                                 "(the reference's native format, "
                                 "train.py:154-206).")
    opt_parser.add_argument("--device", choices=("cuda", "cpu"),
                            default="cuda", dest="device",
                            help="Run on the first CUDA device (raises "
                                 "without one) or on the CPU.")
    if extra_optional is not None:
        extra_optional(opt_parser)

    top_parser = argparse.ArgumentParser(
        usage="%s {cityscapes,freiburg,vistas} [-h/--help]" % prog)
    sub = top_parser.add_subparsers(parser_class=HelpfulParser)

    cityscapes = sub.add_parser(
        "cityscapes", parents=[req_parser, opt_parser],
        conflict_handler="resolve", help="The Cityscapes dataset.")
    cityscapes.set_defaults(dataset="cityscapes")
    cityscapes.add_argument("--use-coarse", action="store_true",
                            required=False, dest="coarse")

    vistas = sub.add_parser(
        "vistas", parents=[req_parser, opt_parser],
        conflict_handler="resolve", help="The Mapillary Vistas dataset.")
    vistas.set_defaults(dataset="vistas")

    freiburg = sub.add_parser(
        "freiburg", parents=[req_parser, opt_parser],
        conflict_handler="resolve", help="The Freiburg Forest dataset.")
    freiburg.set_defaults(dataset="freiburg")
    freiburg.add_argument("-m", "--modalities", type=str, nargs="+",
                          required=False, default=[],
                          help="Dataset modalities to load.")
    return top_parser


def extra_modalities(args) -> tuple:
    """The ``-m/--modalities`` (Freiburg) that stack after the RGB
    planes: every name but ``rgb`` and ``image``, which are the RGB
    planes themselves."""
    return tuple(m for m in (getattr(args, "modalities", None) or ())
                 if m not in ("rgb", "image"))


def parse_dataset_args(prog: str, argv=None, extra_optional=None):
    parser = build_dataset_parser(prog, extra_optional)
    argv = sys.argv[1:] if argv is None else argv
    if not any(ds in argv for ds in ("cityscapes", "freiburg", "vistas")):
        parser.print_help()
        sys.exit(0)
    return parser.parse_args(argv)


def make_dataset(args):
    """Dataset object from parsed args (train.py:27-34)."""
    if args.dataset == "cityscapes":
        return datasets.Cityscapes(coarse=getattr(args, "coarse", False))
    if args.dataset == "freiburg":
        return datasets.Freiburg(
            modalities=getattr(args, "modalities", None) or None)
    if args.dataset == "vistas":
        return datasets.Vistas()
    raise NotImplementedError(
        "Dataset \"%s\" not supported" % args.dataset)


def device_from_args(name: str) -> torch.device:
    """The device ``--device`` names. ``cuda`` (the default) needs a
    CUDA device and raises without one: the CPU runs only when the
    caller asks for it. ``cuda`` is the local rank's card (torchrun's
    ``LOCAL_RANK``, 0 in one process; modulo the card count where the
    ranks of a host share its cards: ``parallel.distributed``)."""
    if name != "cuda":
        return torch.device(name)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "--device cuda: no CUDA device is available (torch "
            f"{torch.__version__}, CUDA build {torch.version.cuda}); pass "
            "--device cpu to run on the CPU")
    return torch.device("cuda", distributed.local_rank()
                        % torch.cuda.device_count())


class StepScalarBuffer:
    """Per-step scalars (the reference's per-iteration loss, cost and
    learning-rate summaries, train.py:167-176, 339-341) kept as the step
    returned them, on the device, until ``flush`` reads them at the
    epoch's end: the train loop never waits on the device for them."""

    def __init__(self, keys):
        self.keys = tuple(keys)
        self._rows = []

    def append(self, metrics) -> None:
        self._rows.append([metrics[k] for k in self.keys])

    def flush(self) -> np.ndarray:
        """Return the ``[n_steps, len(keys)]`` float32 host array."""
        rows, self._rows = self._rows, []
        return np.asarray([[float(v) for v in row] for row in rows],
                          np.float32).reshape(len(rows), len(self.keys))


class MetricsWriter:
    """Append-only JSONL metrics log under the log dir, the rebuild's
    native form of the reference's TensorBoard scalar summaries
    (train.py:154-206); ``tensorboard`` mirrors each record into a
    tfevents file. ``enabled=False`` (a rank other than 0) writes
    nothing."""

    def __init__(self, log_dir: str, filename: str = "metrics.jsonl",
                 tensorboard: bool = False, enabled: bool = True):
        self.enabled = enabled
        self.path = os.path.join(log_dir, filename)
        self._tb = None
        if not enabled:
            return
        os.makedirs(log_dir, exist_ok=True)
        if tensorboard:
            from . import tb_events
            self._tb = tb_events.EventWriter(log_dir)

    @property
    def tb(self):
        """The live ``tb_events.EventWriter`` (None unless
        ``tensorboard=True``)."""
        return self._tb

    def write(self, record: dict) -> None:
        if not self.enabled:
            return
        record = dict(record)
        record.setdefault("wall_time", time.time())
        line = json.dumps(record, default=_json_default)
        with open(self.path, "a") as fp:
            fp.write(line + "\n")
        if self._tb is not None:
            from . import tb_events
            plain = json.loads(line)
            values = tb_events.record_to_values(plain)
            if values:
                self._tb.add_event(tb_events.encode_event(
                    plain["wall_time"], tb_events.record_step(plain),
                    values))

    def close(self) -> None:
        if self._tb is not None:
            self._tb.close()
            self._tb = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _json_default(obj):
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return float(obj)
    return str(obj)


@contextlib.contextmanager
def maybe_trace(trace_dir: Optional[str]):
    """A ``torch.profiler`` trace (CPU and, where present, CUDA
    activity) around the hot loop when ``--trace`` is given, exported
    as a Chrome trace under ``trace_dir``."""
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    os.makedirs(trace_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))


def progress(iterable, desc: str, **kwargs):
    """tqdm when available, like the reference's optional import
    (train.py:12-18)."""
    try:
        import tqdm
        return tqdm.tqdm(iterable, desc=desc, ascii=True,
                         dynamic_ncols=True, **kwargs)
    except ImportError:
        return iterable
