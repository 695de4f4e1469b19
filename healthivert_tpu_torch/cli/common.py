"""Flags the port's CLIs read before the options (healthivert_tpu_torch.config)."""

from __future__ import annotations

import argparse

from ..engine.checkpoint import PRETRAINED_NPZ


def load_npz_parser() -> argparse.ArgumentParser:
    """The port-only --load_npz flag. It is parsed before the options, so
    that vars(opt) and {phase}_opt.txt stay the JAX package's."""
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument(
        "--load_npz", default=None,
        help="generator weights exported to .npz from a JAX package checkpoint "
             f"(the shipped ones: {PRETRAINED_NPZ}); read when neither --load_pth "
             "nor a port checkpoint in {checkpoints_dir}/{name} gives the weights "
             "(training: the generator's starting weights)")
    return pre


def options_with(pre: argparse.ArgumentParser, cls):
    """An options object of class `cls` whose --help also lists the
    pre-parser's flags."""
    o = cls()
    o.epilog = "flags read before these options: " + "; ".join(
        f"{'/'.join(a.option_strings)} (default: {a.default}) {a.help or ''}".strip()
        for a in pre._actions)
    return o
