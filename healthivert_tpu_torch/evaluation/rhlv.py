"""RHLV quantification: the relative height loss between the synthesized
(fake) and the real vertebra.

A copy of healthivert_tpu/evaluation/rhlv.py:25-147, numpy float64 on the
host: per-slice column heights split into anterior, middle and posterior
thirds of the fake segmentation's y-extent, the scale-ratio correction
where the real label is taller than the fake, the 0.7 x centre-height
column filter, and RHLV = (H_fake - H_label) / H_fake per region, over the
sagittal (axis 2) or coronal (axis 1) slices. The tables are written with
`utils.table` (CSV; a ``.xlsx`` name writes the ``.csv`` beside it).
"""

from __future__ import annotations

import os
from typing import Dict, List

import numpy as np

from ..utils import nifti
from ..utils.table import write_rows


def _slice_at(vol: np.ndarray, z: int, axis: int) -> np.ndarray:
    return vol[:, :, z] if axis == 2 else vol[:, z, :]


def calculate_heights(seg_fake, seg_label, height_threshold: float, axis: int = 2):
    """Per-column heights accumulated over the slices: a dict of 8 arrays
    (all/pre/mid/post x fake/label)."""
    acc = {k: [] for k in ("all_f", "all_l", "pre_f", "pre_l", "mid_f", "mid_l", "post_f", "post_l")}
    for z in range(seg_label.shape[axis]):
        lab = _slice_at(seg_label, z, axis)
        fak = _slice_at(seg_fake, z, axis)
        if not (lab.any() and fak.any()):
            continue
        loc = np.where(fak)[1]
        y_min, y_max = int(loc.min()), int(loc.max())
        y_range = y_max - y_min
        one_third = int(y_min + y_range / 3)
        two_third = int(y_min + 2 * y_range / 3)

        center_f = np.count_nonzero(fak[:, int(loc.mean())])
        all_f = np.count_nonzero(fak, axis=0)
        pre_f = np.count_nonzero(fak[:, :one_third], axis=0)
        mid_f = np.count_nonzero(fak[:, one_third:two_third], axis=0)
        post_f = np.count_nonzero(fak[:, two_third:], axis=0)

        lloc = np.where(lab)[1]
        center_l = np.count_nonzero(lab[:, int(lloc.mean())])
        all_l = np.count_nonzero(lab, axis=0)
        pre_l = np.count_nonzero(lab[:, :one_third], axis=0)
        mid_l = np.count_nonzero(lab[:, one_third:two_third], axis=0)
        post_l = np.count_nonzero(lab[:, two_third:], axis=0)

        def ratio(l, f):
            if l.size and f.size and l.max() > f.max():
                return l.max() / (f.max() + 1e-6)
            return 1.0

        r_all, r_pre, r_mid, r_post = (
            ratio(all_l, all_f), ratio(pre_l, pre_f), ratio(mid_l, mid_f), ratio(post_l, post_f),
        )
        all_f = all_f * r_all
        center_fs = center_f * r_all
        pre_f = pre_f * r_pre
        mid_f = mid_f * r_mid
        post_f = post_f * r_post

        t = height_threshold
        acc["all_f"].extend(all_f[all_f > center_fs * t])
        acc["all_l"].extend(all_l[all_l > center_l * t])
        acc["pre_f"].extend(pre_f[pre_f > center_fs * t])
        acc["pre_l"].extend(pre_l[pre_l > center_l * t])
        acc["mid_f"].extend(mid_f[mid_f > center_fs * t])
        acc["mid_l"].extend(mid_l[mid_l > center_l * t])
        acc["post_f"].extend(post_f[post_f > center_fs * t])
        acc["post_l"].extend(post_l[post_l > center_l * t])
    return {k: np.array(v) for k, v in acc.items()}


def calculate_rhlv(seg_fake, seg_label, center_z, length, height_threshold=0.7, axis: int = 2):
    """RHLV over the central window [center_z - length, center_z + length):
    (all, pre, mid, post, relative height of the label).

    The window's start is clamped to 0, as in the JAX package: the
    reference lets center_z - length go negative, which wraps the slice to
    an empty window and gives an all-zero row for a label near the edge."""
    sl = [slice(None)] * 3
    sl[axis] = slice(max(0, center_z - length), center_z + length)
    h = calculate_heights(seg_fake[tuple(sl)], seg_label[tuple(sl)], height_threshold, axis)

    def mean(a):
        return float(np.mean(a)) if a.size else 0.0

    all_f, all_l = mean(h["all_f"]), mean(h["all_l"])
    pre_f, pre_l = mean(h["pre_f"]), mean(h["pre_l"])
    mid_f, mid_l = mean(h["mid_f"]), mean(h["mid_l"])
    post_f, post_l = mean(h["post_f"]), mean(h["post_l"])

    def rhlv(f, l):
        return (f - l) / (f + 1e-6)

    mn, mx = min(pre_l, mid_l, post_l), max(pre_l, mid_l, post_l)
    return (
        rhlv(all_f, all_l), rhlv(pre_f, pre_l), rhlv(mid_f, mid_l), rhlv(post_f, post_l),
        mn / (mx + 1e-6),
    )


def process_datasets(
    dataset_info: Dict[str, Dict[str, int]],
    label_folder: str,
    fake_folder: str,
    output_file: str,
    length_divisor: int = 5,
    height_threshold: float = 0.7,
    axis: int = 2,
) -> List[dict]:
    """Walk {dataset: {vertebra: grade}}, compute the RHLV rows and write
    them to `output_file` (CSV) when it is given."""
    results = []
    for dataset_type, data in dataset_info.items():
        for vertebra, grade in data.items():
            lp = os.path.join(label_folder, vertebra + ".nii.gz")
            fp = os.path.join(fake_folder, vertebra + ".nii.gz")
            if not (os.path.exists(lp) and os.path.exists(fp)):
                continue
            lab_t = nifti.load(lp).get_fdata()
            fak_t = nifti.load(fp).get_fdata()
            vid = int(vertebra.split("_")[-1])
            lab = (lab_t == vid).astype(np.float64)
            fak = (fak_t == vid).astype(np.float64)
            loc = np.where(lab)[axis]
            if loc.size == 0:
                continue
            center = int(loc.mean())
            length = (int(loc.max()) - int(loc.min())) // length_divisor
            a, p, m, po, rel = calculate_rhlv(fak, lab, center, length, height_threshold, axis)
            results.append({
                "Vertebra": vertebra, "Label": grade, "Dataset": dataset_type,
                "All RHLV": a, "Pre RHLV": p, "Mid RHLV": m, "Post RHLV": po,
                "Relative Height Label": rel,
            })
    if output_file:
        write_rows(results, output_file)
    return results
