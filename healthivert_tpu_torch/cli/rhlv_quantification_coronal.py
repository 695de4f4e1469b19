"""Coronal RHLV quantification: `rhlv_quantification` with --coronal
(the root evaluation/RHLV_quantification_coronal.py)."""

import sys

from .rhlv_quantification import main as _main


def main(argv=None):
    return _main(list(sys.argv[1:] if argv is None else argv) + ["--coronal"])


if __name__ == "__main__":
    main()
