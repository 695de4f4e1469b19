"""Generation-quality evaluation CLI of the port (sagittal; --coronal for
axis 1).

Counterpart of the root evaluation/generation_eval_sagittal.py, with its
flags:

    python -m healthivert_tpu_torch.cli.generation_eval_sagittal --split vertebra_data.json \\
        --phase val --ct_folder <straightened/CT> --label_folder <straightened/label> \\
        --output_folder <output_3d-with-experiment-dirs> --result_folder <out>

The PSNR/SSIM batches run on the card of --gpu_ids (default 0, which
raises without a card); --gpu_ids -1 runs them on the CPU. With
--coronal, only experiment dirs whose name holds "coronal" are read, as
the reference's coronal script does.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from ..config.options import device_from_gpu_ids
from ..evaluation.generation import evaluate_experiment
from ..utils.device import float32_exact


def main(argv=None):
    float32_exact()
    p = argparse.ArgumentParser()
    p.add_argument("--split", default="vertebra_data.json")
    p.add_argument("--phase", default="val")
    p.add_argument("--ct_folder", required=True)
    p.add_argument("--label_folder", required=True)
    p.add_argument("--output_folder", required=True)
    p.add_argument("--result_folder", required=True)
    p.add_argument("--coronal", action="store_true")
    p.add_argument("--gpu_ids", default="0",
                   help="the card for the PSNR/SSIM batches; -1 runs them on the CPU")
    args = p.parse_args(argv)
    device = device_from_gpu_ids(args.gpu_ids)

    with open(args.split) as f:
        split = json.load(f)[args.phase]
    os.makedirs(args.result_folder, exist_ok=True)
    axis = 1 if args.coronal else 2

    exps = [
        d for d in sorted(os.listdir(args.output_folder))
        if os.path.isdir(os.path.join(args.output_folder, d, "CT_fake"))
    ]
    if not exps and os.path.isdir(os.path.join(args.output_folder, "CT_fake")):
        exps = ["."]
    results = {}
    for d in exps:
        name = os.path.basename(os.path.abspath(os.path.join(args.output_folder, d)))
        if args.coronal and "coronal" not in name and d != ".":
            continue  # the reference's coronal filter (generation_eval_coronal.py:132-135)
        out = os.path.join(args.result_folder, name + ".txt")
        avg = evaluate_experiment(
            split, args.ct_folder, args.label_folder,
            os.path.join(args.output_folder, d), out, axis, device=device,
        )
        results[out] = avg
        print(name, {k: round(v, 4) if isinstance(v, float) else v for k, v in avg.items()})
    return results


if __name__ == "__main__":
    main(sys.argv[1:])
