"""CLI argument parsing and config loading: the port's copy of
``advise_tpu/config/parser.py:16-53`` (same surface as the reference
launcher, reference ``utils/parser.py:5-52``): ``--cfg`` accepts several
YAML files merged in order, ``--output`` becomes ``cfg.LOGDIR``, and the
trailing ``K V ...`` pairs apply dotted-key overrides last."""

import argparse
import sys
from typing import List, Optional

from advise_tpu_torch.config.defaults import get_cfg
from advise_tpu_torch.config.node import CfgNode


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        description="advise_tpu_torch: the PyTorch/CUDA port of advise_tpu"
    )
    parser.add_argument(
        "--cfg",
        dest="cfg_files",
        help="Path(s) to YAML config file(s), merged in order",
        default=None,
        nargs="+",
    )
    parser.add_argument(
        "--output",
        dest="output",
        help="Working/log directory (becomes cfg.LOGDIR)",
        default="./runs/default",
        type=str,
    )
    parser.add_argument(
        "opts",
        help="See advise_tpu_torch/config/defaults.py for all options",
        default=None,
        nargs=argparse.REMAINDER,
    )
    if argv is None and len(sys.argv) == 1:
        parser.print_help()
    return parser.parse_args(argv)


def load_config(args: argparse.Namespace) -> CfgNode:
    cfg = get_cfg()
    if args.cfg_files is not None:
        for cfg_file in args.cfg_files:
            cfg.merge_from_file(cfg_file)
    if args.opts:
        cfg.merge_from_list(args.opts)
    cfg.LOGDIR = args.output
    return cfg
