"""SVM Genant grading CLI of the port.

Counterpart of the root evaluation/SVM_grading.py, with its flags:

    python -m healthivert_tpu_torch.cli.svm_grading --result_folder <rhlv-tables-dir> \\
        --grading_folder <out-dir>

Grades each RHLV table (.csv; an .xlsx name stands for the .csv beside it)
in --result_folder with the sagittal features and writes
{grading_folder}/{table}.txt. Host numpy only: no device.
"""

from __future__ import annotations

import argparse
import os
import sys

from ..evaluation.grading import FEATURES_SAGITTAL, evaluate_svm
from ..utils.device import float32_exact


def main(argv=None):
    float32_exact()
    p = argparse.ArgumentParser()
    p.add_argument("--result_folder", default="evaluation/RHLV_quantification")
    p.add_argument("--grading_folder", default="evaluation/classification_metric")
    args = p.parse_args(argv)

    os.makedirs(args.grading_folder, exist_ok=True)
    summaries = {}
    for f in sorted(os.listdir(args.result_folder)):
        if not (f.endswith(".csv") or f.endswith(".xlsx")):
            continue
        name = f.rsplit(".", 1)[0]
        out = os.path.join(args.grading_folder, name + ".txt")
        s = evaluate_svm(os.path.join(args.result_folder, f), FEATURES_SAGITTAL, out)
        summaries[out] = s
        print(f"{name}: macro-F1 {s['f1']['mean']:.4f} P {s['precision']['mean']:.4f} "
              f"R {s['recall']['mean']:.4f}")
    return summaries


if __name__ == "__main__":
    main(sys.argv[1:])
