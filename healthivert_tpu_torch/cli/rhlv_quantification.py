"""RHLV quantification CLI of the port (sagittal; --coronal for axis 1).

Counterpart of the root evaluation/RHLV_quantification.py, with its flags:

    python -m healthivert_tpu_torch.cli.rhlv_quantification --split vertebra_data.json \\
        --label_folder <straightened/label> --output_folder <output_3d> \\
        --result_folder <out-dir> [--coronal]

Walks each experiment dir under --output_folder (with label_fake/ inside;
--output_folder may itself be one) and writes one RHLV table per
experiment, {result_folder}/{experiment}.csv. Host numpy only: no device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from ..evaluation.rhlv import process_datasets
from ..utils.device import float32_exact


def main(argv=None):
    float32_exact()
    p = argparse.ArgumentParser()
    p.add_argument("--split", default="vertebra_data.json")
    p.add_argument("--label_folder", required=True)
    p.add_argument("--output_folder", required=True)
    p.add_argument("--result_folder", required=True)
    p.add_argument("--length_divisor", type=int, default=5)
    p.add_argument("--height_threshold", type=float, default=0.7)
    p.add_argument("--coronal", action="store_true", help="iterate axis 1 instead of 2")
    args = p.parse_args(argv)

    with open(args.split) as f:
        json_data = json.load(f)
    os.makedirs(args.result_folder, exist_ok=True)
    axis = 1 if args.coronal else 2

    exps = [
        d for d in sorted(os.listdir(args.output_folder))
        if os.path.isdir(os.path.join(args.output_folder, d, "label_fake"))
    ]
    if not exps and os.path.isdir(os.path.join(args.output_folder, "label_fake")):
        exps = ["."]
    tables = {}
    for d in exps:
        fake = os.path.join(args.output_folder, d, "label_fake")
        name = os.path.basename(os.path.abspath(os.path.join(args.output_folder, d)))
        out = os.path.join(args.result_folder, name + ".csv")
        rows = process_datasets(
            json_data, args.label_folder, fake, out,
            args.length_divisor, args.height_threshold, axis,
        )
        tables[out] = rows
        print(f"{name}: {len(rows)} vertebrae -> {out}")
    return tables


if __name__ == "__main__":
    main(sys.argv[1:])
