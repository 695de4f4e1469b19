"""2.5D SVM grading CLI of the port: the sagittal and coronal RHLV tables
joined on Vertebra, 6 features.

Counterpart of the root evaluation/SVM_grading_2.5d.py (a dot cannot stand
in a module name), with its flags:

    python -m healthivert_tpu_torch.cli.svm_grading_2_5d --sagittal <table> \\
        --coronal <table> --output <txt>

Host numpy only: no device.
"""

from __future__ import annotations

import argparse
import sys

from ..evaluation.grading import evaluate_svm_25d
from ..utils.device import float32_exact


def main(argv=None):
    float32_exact()
    p = argparse.ArgumentParser()
    p.add_argument("--sagittal", required=True)
    p.add_argument("--coronal", required=True)
    p.add_argument("--output", default="classification_2.5d.txt")
    args = p.parse_args(argv)
    s = evaluate_svm_25d(args.sagittal, args.coronal, args.output)
    print(f"2.5D macro-F1 {s['f1']['mean']:.4f} P {s['precision']['mean']:.4f} "
          f"R {s['recall']['mean']:.4f}")
    return s


if __name__ == "__main__":
    main(sys.argv[1:])
