"""A small raw cohort on disk for the straightening tests
(tests/test_torch_straighten.py, tests/test_torch_cli_straighten.py,
tests/test_torch_cuda_cli.py): three patients of five vertebrae (labels
18-22) on a bent spine in a (96, 96, 160) CT in Hounsfield units, written
with the port's NIfTI writer so that the card-only tests, on a machine
without JAX, can use it too:

- p0: RAI, its mask as p0_msk.nii.gz;
- p1: RAI, its mask as p1_seg.nii.gz, the last vertebra cut by the field
  of view to 6 slices (fewer than the 8000 voxels location_json_local
  keeps of a top label);
- p2: the same scan as a third spine stored R, P, I (flipped along axis 1,
  the sagittal normal about which the spine is symmetric, so that the
  centroids of the stored mask hold after --reorient RAI as well).
"""

import json
import os

import numpy as np

from healthivert_tpu_torch.data.raw_spine import make_raw_spine, raw_affine, write_raw_patient

SHAPE = (96, 96, 160)
VERTS = (18, 19, 20, 21, 22)
SIZE = ("64", "64", "32")
SPLIT = {"train": {"p0": [19, 20, 21], "p2": [20]}, "test": {"p1": [18, 22]}}


def spine(p):
    rng = np.random.default_rng(10 + p)
    return make_raw_spine(rng, SHAPE, VERTS, radii=(14, 12), bend=(8.0, -6.0, 10.0)[p],
                          last_height=6 if p == 1 else None)


def write_raw_cohort(root):
    for p in range(3):
        ct, labels = spine(p)
        if p == 2:
            ct, labels = ct[:, ::-1], labels[:, ::-1]
        write_raw_patient(root, f"p{p}", ct, labels, raw_affine(SHAPE, flip_axis1=p == 2),
                          "seg" if p == 1 else "msk")
    with open(os.path.join(root, "split.json"), "w") as f:
        json.dump(SPLIT, f)
    return root
