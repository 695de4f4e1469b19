"""Coronal generation evaluation: `generation_eval_sagittal` with --coronal
(the root evaluation/generation_eval_coronal.py)."""

import sys

from .generation_eval_sagittal import main as _main


def main(argv=None):
    return _main(list(sys.argv[1:] if argv is None else argv) + ["--coronal"])


if __name__ == "__main__":
    main()
