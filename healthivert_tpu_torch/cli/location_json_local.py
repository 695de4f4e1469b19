"""Centroid extraction CLI of the port: per-patient vertebra centres of mass.

Counterpart of the root straighten/location_json_local.py, with its flags:

    python -m healthivert_tpu_torch.cli.location_json_local --root <raw-root>

Reads {root}/{patient}/{patient}_seg.nii.gz (or _msk) and writes
{root}/{patient}/{patient}.json, the labels sorted, dropping a small top
(< 8000 voxels) or bottom (< 6000) vertebra. Host numpy; --gpu_ids (default
0, which raises without a card; -1 for the CPU) selects the device as in
the port's other CLIs, though no step here runs on it.
"""

from __future__ import annotations

import argparse
import os
import sys

from ..config.options import device_from_gpu_ids
from ..straighten.pipeline import write_centroid_json
from ..utils.device import float32_exact


def main(argv=None):
    float32_exact()
    p = argparse.ArgumentParser()
    p.add_argument("--root", required=True)
    p.add_argument("--gpu_ids", default="0",
                   help="the port's device flag (-1: the CPU); the centroids are host numpy")
    args = p.parse_args(argv)
    device_from_gpu_ids(args.gpu_ids)
    written = {}
    for patient in sorted(os.listdir(args.root)):
        pdir = os.path.join(args.root, patient)
        if not os.path.isdir(pdir):
            continue
        seg = os.path.join(pdir, f"{patient}_seg.nii.gz")
        if not os.path.exists(seg):
            seg = os.path.join(pdir, f"{patient}_msk.nii.gz")
        if not os.path.exists(seg):
            continue
        data = write_centroid_json(seg, os.path.join(pdir, f"{patient}.json"))
        print(patient, [e["label"] for e in data])
        written[patient] = data
    return written


if __name__ == "__main__":
    main(sys.argv[1:])
