"""Generation quality: 3D IoU, Dice and relative volume difference, and the
patch and global PSNR/SSIM of the synthesized CT.

Counterpart of healthivert_tpu/evaluation/generation.py:23-204: metrics on
the val vertebrae of grade 0 only, slices restricted to the central 4/5
with > 400 foreground pixels, patch metrics on the rows cropped to the
vertebra's extent, SSIM with scikit-image's defaults (`ops.image`). The
PSNR/SSIM of a group of same-shape slices runs as one
`ops.image.psnr_ssim_batch` call on the given device (the card by default,
as the JAX package runs it on its device); the 3D overlap metrics are numpy
on the host.

The JAX package pads each batch to a multiple of 8 slices so that XLA
reuses its compilations (`_bucket`, :40-47). A row's value does not depend
on its batch, and PyTorch compiles nothing, so the port sends each group
as it is.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch

from ..ops import image as I
from ..utils import nifti
from ..utils.device import resolve_device
from .rhlv import _slice_at


def calculate_iou(a, b):
    inter = np.sum(a * b)
    union = np.sum((a + b) > 0)
    return inter / union if union else 0.0


def calculate_dice(a, b):
    inter = np.sum(a * b)
    union = np.sum(a) + np.sum(b)
    return 2.0 * inter / union if union else 0.0


def relative_volume_difference(a, b):
    va, vb = np.sum(a), np.sum(b)
    return abs(va - vb) / va if va else 0.0


def _metric_rows(rows, device="cuda"):
    """PSNR and SSIM of a list of same-shape (a, b, data_range) slice pairs,
    in one psnr_ssim_batch call on `device`. Two lists aligned with `rows`,
    NaN where dr <= 0 (both) or a side is under 7 pixels (SSIM)."""
    n = len(rows)
    if n == 0:
        return [], []
    dev = resolve_device(device)
    h, w = rows[0][0].shape
    a = np.stack([r[0] for r in rows]).astype(np.float32)
    b = np.stack([r[1] for r in rows]).astype(np.float32)
    # a placeholder range where the reference's guard fires; masked below
    dr = np.array([r[2] if r[2] > 0 else 1.0 for r in rows], np.float32)
    with_ssim = min(h, w) >= 7
    p, s = I.psnr_ssim_batch(torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev),
                             torch.from_numpy(dr).to(dev), with_ssim=with_ssim)
    p = p.cpu().numpy()
    psnrs = [float(p[i]) if rows[i][2] > 0 else np.nan for i in range(n)]
    if not with_ssim:
        return psnrs, [np.nan] * n
    s = s.cpu().numpy()
    return psnrs, [float(s[i]) if rows[i][2] > 0 else np.nan for i in range(n)]


def process_images(ori_ct_path, fake_ct_path, ori_seg_path, fake_seg_path, axis=2,
                   device="cuda") -> Dict[str, float]:
    """The metrics of one vertebra; the patch and global ones are 0 when its
    label volume lacks the vertebra's id."""
    ori_ct = nifti.load(ori_ct_path).get_fdata()
    fake_ct = nifti.load(fake_ct_path).get_fdata()
    vid = int(os.path.basename(ori_seg_path)[: -len(".nii.gz")].split("_")[-1])
    ori_seg = (nifti.load(ori_seg_path).get_fdata() == vid).astype(np.float64)
    fake_seg = (nifti.load(fake_seg_path).get_fdata() == vid).astype(np.float64)

    out = dict(
        iou=calculate_iou(ori_seg, fake_seg),
        dice=calculate_dice(ori_seg, fake_seg),
        rvd=relative_volume_difference(ori_seg, fake_seg),
    )

    loc = np.where(ori_seg)[axis]
    if loc.size == 0:
        # no slices to measure: zero patch metrics make evaluate_experiment
        # skip this vertebra, as the reference does (:142-147)
        out.update(patch_psnr=0.0, patch_ssim=0.0, global_psnr=0.0, global_ssim=0.0)
        return out
    z0, z1 = int(loc.min()), int(loc.max())
    range_length = z1 - z0 + 1
    new_len = int(range_length * 4 / 5)
    nz0 = z0 + (range_length - new_len) // 2
    nz1 = nz0 + new_len - 1

    # every valid slice first, then one batch for the global slices (one
    # shape) and one per patch-crop height
    glob_rows, patch_groups = [], {}
    for z in range(nz0, nz1 + 1):
        seg_sl = _slice_at(ori_seg, z, axis)
        if seg_sl.sum() <= 400:
            continue
        rows = np.argwhere(seg_sl)[:, 0]
        x1, x2 = int(rows.min()), int(rows.max())
        co = _slice_at(ori_ct, z, axis)[x1 : x2 + 1]
        cf = _slice_at(fake_ct, z, axis)[x1 : x2 + 1]
        patch_groups.setdefault(x2 - x1 + 1, []).append((co, cf, co.max() - co.min()))

        go = _slice_at(ori_ct, z, axis)
        gf = _slice_at(fake_ct, z, axis)
        glob_rows.append((go, gf, go.max() - go.min()))

    patch_psnr, patch_ssim, glob_psnr, glob_ssim = [], [], [], []
    for group in patch_groups.values():
        ps, ss = _metric_rows(group, device=device)
        patch_psnr += [p for p in ps if not np.isnan(p)]
        patch_ssim += [s for s in ss if not np.isnan(s)]
    ps, ss = _metric_rows(glob_rows, device=device)
    glob_psnr += [p for p in ps if not np.isnan(p)]
    glob_ssim += [s for s in ss if not np.isnan(s)]

    out.update(
        patch_psnr=float(np.mean(patch_psnr)) if patch_psnr else 0.0,
        patch_ssim=float(np.mean(patch_ssim)) if patch_ssim else 0.0,
        global_psnr=float(np.mean(glob_psnr)) if glob_psnr else 0.0,
        global_ssim=float(np.mean(glob_ssim)) if glob_ssim else 0.0,
    )
    return out


def evaluate_experiment(
    split: Dict[str, int],
    ct_folder: str,
    label_folder: str,
    fake_folder: str,
    output_txt: str = None,
    axis: int = 2,
    device="cuda",
) -> Dict[str, float]:
    """Average metrics over the grade-0 vertebrae of one experiment dir
    (generation_eval_sagittal.py:114-162 of the reference). A vertebra whose
    patch PSNR or SSIM is 0 or NaN is left out of every average, IoU and
    Dice included, and of the count."""
    sums, n = {}, 0
    for vertebra, grade in split.items():
        if int(grade) != 0:
            continue
        paths = dict(
            ori_ct=os.path.join(ct_folder, vertebra + ".nii.gz"),
            fake_ct=os.path.join(fake_folder, "CT_fake", vertebra + ".nii.gz"),
            ori_seg=os.path.join(label_folder, vertebra + ".nii.gz"),
            fake_seg=os.path.join(fake_folder, "label_fake", vertebra + ".nii.gz"),
        )
        if not all(os.path.exists(p) for p in paths.values()):
            continue
        m = process_images(paths["ori_ct"], paths["fake_ct"], paths["ori_seg"],
                           paths["fake_seg"], axis, device=device)
        if (
            np.isnan(m["patch_psnr"]) or np.isnan(m["patch_ssim"])
            or m["patch_psnr"] == 0 or m["patch_ssim"] == 0
        ):
            continue
        for k, v in m.items():
            sums[k] = sums.get(k, 0.0) + v
        n += 1
    avg = {k: v / n for k, v in sums.items()} if n else {}
    avg["count"] = n
    if output_txt and avg:
        with open(output_txt, "w") as f:
            for k, v in avg.items():
                f.write(f"{k}: {v}\n")
    return avg
