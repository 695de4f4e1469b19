"""Spine straightening and de-pedicle masking CLI of the port.

Counterpart of the root straighten/straighten_mask_3d.py, with its flags.
Per patient: HU window, the CT (order 1) and the labels (order 0)
resampled along the extended centroid curve with the sagittal-constrained
basis, posterior-element cleanup, then per-vertebra crops of --size and
de-pedicle masks into {out}/{CT,label,mask_2d}/{patient}_{vert}.nii.gz:

    # every vertebra of each patient's centroid json (location_json_local):
    python -m healthivert_tpu_torch.cli.straighten_mask_3d --root <raw-root> --out <dir>
    # or those of a split json {category: {patient: [vert_ids]}}:
    python -m healthivert_tpu_torch.cli.straighten_mask_3d --root <raw-root> --out <dir> \\
        --split patient_vertebrae.json

The resamples run on the card of --gpu_ids (default 0, which raises
without a card); --gpu_ids -1 runs them on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from ..config.options import device_from_gpu_ids
from ..straighten.pipeline import process_data, process_mask3d
from ..utils.device import float32_exact


def main(argv=None):
    float32_exact()
    p = argparse.ArgumentParser()
    p.add_argument("--root", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--split", default=None)
    p.add_argument("--size", type=int, nargs=3, default=(256, 256, 64))
    p.add_argument("--mask_mode", choices=("rect", "left", "3d"), default="rect",
                   help="de-pedicle mask strategy (reference alternates :308-363/:438-461)")
    p.add_argument("--reorient", default=None, metavar="RAI",
                   help="reorient volumes to this axis-code order before straightening")
    p.add_argument("--gpu_ids", default="0",
                   help="the card for the resamples; -1 runs them on the CPU")
    args = p.parse_args(argv)
    device = device_from_gpu_ids(args.gpu_ids)

    if args.split:
        with open(args.split) as f:
            data = json.load(f)
        done = process_data(args.root, data, args.out, tuple(args.size),
                            mask_mode=args.mask_mode, reorient=args.reorient, device=device)
        print(f"straightened {len(done)} vertebrae")
        return done

    done = []
    for patient in sorted(os.listdir(args.root)):
        pdir = os.path.join(args.root, patient)
        js = os.path.join(pdir, f"{patient}.json")
        ct = os.path.join(pdir, f"{patient}.nii.gz")
        msk = os.path.join(pdir, f"{patient}_msk.nii.gz")
        if not os.path.exists(msk):
            msk = os.path.join(pdir, f"{patient}_seg.nii.gz")
        if not (os.path.exists(js) and os.path.exists(msk)):
            continue
        if not os.path.exists(ct):
            print(f"{patient}: no raw CT, straightening labels only (CT=labels)")
            ct = msk
        with open(js) as f:
            vert_ids = [e["label"] for e in json.load(f) if isinstance(e, dict)]
        outs = process_mask3d(ct, msk, js, vert_ids, args.out, tuple(args.size),
                              mask_mode=args.mask_mode, reorient=args.reorient, device=device)
        print(patient, "->", outs)
        done += outs
    return done


if __name__ == "__main__":
    main(sys.argv[1:])
