"""Offline 3D preprocessing: spine straightening, de-pedicle masking, crops.

Counterpart of healthivert_tpu/straighten/pipeline.py: host numpy over the
port's NIfTI IO (utils.nifti), the curve resample on the device
(straighten.curve, on `device`: the card unless the caller passes "cpu"),
and the per-slice min-area-rect mask geometry on the native C++ kernels
(ops.native_geometry) instead of OpenCV.

Conventions: volumes are (X, Y, Z) like the reference's nibabel arrays;
per-slice images are volume[:, :, z] with axis 0 = rows.
"""

from __future__ import annotations

import json
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Sequence

import numpy as np

from ..ops import native_geometry as ng
from ..utils import nifti
from .curve import Interpolator, sagittal_basis


def window(img: np.ndarray, win_min: float, win_max: float) -> np.ndarray:
    """HU windowing to [0, 255] (straighten_mask_3d.py:172-184), incl. the
    reference's early-return when the volume is already inside the window."""
    if img.max() < win_max and img.min() > win_min:
        return img
    out = 255.0 * (img - win_min) / (win_max - win_min)
    return np.clip(out, 0, 255)


def extend_curve(curve: np.ndarray, extension_length: float, min_bounds, max_bounds):
    """Extend both curve ends along the terminal directions, clamped to the
    volume bounds (straighten_mask_3d.py:96-121)."""
    d_end = curve[-1] - curve[-2]
    p_end = curve[-1] + d_end / np.linalg.norm(d_end) * extension_length
    d_start = curve[0] - curve[1]
    p_start = curve[0] + d_start / np.linalg.norm(d_start) * extension_length
    p_end = np.clip(p_end, min_bounds, max_bounds)
    p_start = np.clip(p_start, min_bounds, max_bounds)
    return np.vstack([p_start, curve, p_end])


def remove_spine_labels_after_split(label_image: np.ndarray) -> np.ndarray:
    """Posterior-element cleanup: walking backwards from the mid-coronal
    plane, zero a vertebra's label once it leaves the midline column
    (straighten_mask_3d.py:123-145)."""
    label_image = np.array(label_image)  # ensure writable
    depth, height, width = label_image.shape
    center_y = height // 2
    for label in np.unique(label_image):
        if label == 0:
            continue
        for h in range(center_y, height):
            if label not in label_image[:, h, width // 2]:
                region = label_image[:, h:height, :]
                region[region == label] = 0
                break
    return label_image


def extract_3d_volume(data: np.ndarray, center, size=(256, 256, 64)) -> np.ndarray:
    """Center-crop (zero-padded) a volume around `center`
    (straighten_mask_3d.py:222-247)."""
    x, y, z = center
    dx, dy, dz = size
    z_min, z_max = max(0, int(z - dz // 2)), min(data.shape[2], int(z + dz // 2))
    y_min, y_max = max(0, int(y - dy // 2)), min(data.shape[1], int(y + dy // 2))
    x_min, x_max = max(0, int(x - dx // 2)), min(data.shape[0], int(x + dx // 2))
    extracted = data[x_min:x_max, y_min:y_max, z_min:z_max]
    out = np.zeros(size, dtype=data.dtype)
    sx = (dx - (x_max - x_min)) // 2
    sy = (dy - (y_max - y_min)) // 2
    sz = (dz - (z_max - z_min)) // 2
    if sz < 0:
        out[sx : sx + (x_max - x_min), sy : sy + (y_max - y_min), : size[2]] = (
            extracted[:, :, : size[2]]
        )
    else:
        out[
            sx : sx + (x_max - x_min), sy : sy + (y_max - y_min), sz : sz + (z_max - z_min)
        ] = extracted
    return out


def _remove_small_components(binary: np.ndarray, area_threshold: float) -> np.ndarray:
    """Drop connected components with area <= threshold (the reference drops
    contours whose cv2.contourArea <= threshold; pixel count is the
    equivalent criterion on filled bodies)."""
    labels, n = ng.cc_label(binary)
    if n == 0:
        return np.zeros_like(binary, np.uint8)
    sizes = np.bincount(labels.ravel())
    keep = np.zeros_like(binary, np.uint8)
    for i in range(1, n + 1):
        if sizes[i] > area_threshold:
            keep[labels == i] = 255
    return keep


def extract_mask_volume(label_data: np.ndarray, label: int, area_threshold: int = 20):
    """Per-slice de-pedicle mask: 1.1x-scaled min-area-rect of the cleaned
    vertebra body minus other-vertebra pixels (straighten_mask_3d.py:381-436)."""
    loc = np.where(label_data == label)
    if loc[2].size == 0:
        return np.zeros_like(label_data, np.float64)
    z0, z1 = int(loc[2].min()), int(loc[2].max())
    other = (label_data != label) & (label_data != 0)
    binary = (label_data == label).astype(np.uint8)

    mask_volume = np.zeros(label_data.shape, np.float64)
    h, w = label_data.shape[:2]
    for z in range(z0, z1 + 1):
        cleaned = _remove_small_components(binary[:, :, z] * 255, area_threshold)
        pts_rc = np.argwhere(cleaned)
        if pts_rc.size == 0:
            continue
        # (x=col, y=row) points for the rect geometry
        pts = pts_rc[:, ::-1].astype(np.float64)
        corners, center = ng.min_area_rect(pts)
        scaled = (corners - center) * 1.1 + center
        # fill_convex_quad rints internally (the reference truncates via
        # np.int0, straighten_mask_3d.py:401-403, so rasters can differ by
        # ~1 px at corner boundaries; masks are not bit-pinned, labels are)
        bbox = ng.fill_convex_quad(scaled, (h, w), 255)
        bbox[other[:, :, z]] = 0
        mask_volume[:, :, z] = bbox
    return mask_volume


def extract_mask_volume_left(label_data: np.ndarray, label: int):
    """Alternate strategy (straighten_mask_3d.py:308-363): per slice, keep
    only the LEFTMOST connected component of the vertebra (by min bounding-box
    column) before the 1.1x min-area-rect — a pedicle workaround for data
    that skipped the posterior-element cleanup. Slices whose component
    vanishes simply get no mask (same as the reference's bare except)."""
    loc = np.where(label_data == label)
    if loc[2].size == 0:
        return np.zeros_like(label_data, np.float64)
    z0, z1 = int(loc[2].min()), int(loc[2].max())
    other = (label_data != label) & (label_data != 0)
    binary = (label_data == label).astype(np.uint8)

    mask_volume = np.zeros(label_data.shape, np.float64)
    h, w = label_data.shape[:2]
    for z in range(z0, z1 + 1):
        labels, n = ng.cc_label(binary[:, :, z])
        if n == 0:
            continue
        # leftmost component = smallest bounding-box column
        best, best_col = None, None
        for i in range(1, n + 1):
            cols = np.where(labels == i)[1]
            if cols.size == 0:
                continue
            c = int(cols.min())
            if best_col is None or c < best_col:
                best, best_col = i, c
        pts_rc = np.argwhere(labels == best)
        pts = pts_rc[:, ::-1].astype(np.float64)  # (x=col, y=row)
        corners, center = ng.min_area_rect(pts)
        scaled = (corners - center) * 1.1 + center
        # fill_convex_quad rints internally (the reference truncates via
        # np.int0, straighten_mask_3d.py:401-403, so rasters can differ by
        # ~1 px at corner boundaries; masks are not bit-pinned, labels are)
        bbox = ng.fill_convex_quad(scaled, (h, w), 255)
        bbox[other[:, :, z]] = 0
        mask_volume[:, :, z] = bbox
    return mask_volume


def extract_mask_3dvolume(label_data: np.ndarray, label: int):
    """Alternate strategy (straighten_mask_3d.py:438-461): one axis-aligned
    3D bounding box of the vertebra, grown 1.1x in-plane around its center,
    value 255, other-vertebra voxels zeroed."""
    loc = np.where(label_data == label)
    if loc[0].size == 0:
        return np.zeros(label_data.shape, np.uint8)
    x_min, x_max = int(loc[0].min()), int(loc[0].max())
    y_min, y_max = int(loc[1].min()), int(loc[1].max())
    z_min, z_max = int(loc[2].min()), int(loc[2].max())

    scale = 1.1
    cx, cy = int((x_max + x_min) / 2), int((y_max + y_min) / 2)
    x_min = int((x_min - cx) * scale + cx)
    x_max = int((x_max - cx) * scale + cx)
    y_min = int((y_min - cy) * scale + cy)
    y_max = int((y_max - cy) * scale + cy)
    # clamp: the reference leaves negative starts, which numpy-wrap to an
    # empty slice for vertebrae touching the volume edge — clamping is the
    # intended box
    x_min, y_min = max(x_min, 0), max(y_min, 0)

    mask = np.zeros(label_data.shape, np.uint8)
    mask[x_min : x_max + 1, y_min : y_max + 1, z_min : z_max + 1] = 255
    mask[(label_data != label) & (label_data != 0)] = 0
    return mask


# ------------------------------------------------------------ centroids

def calculate_center_of_mass(data: np.ndarray, label: int) -> np.ndarray:
    return np.mean(np.argwhere(data == label), axis=0)


def _label_moments(seg: np.ndarray):
    """(voxel count, index sums (n, 3)) of every label value 0..n-1 of a
    non-negative integer volume, in int64: one histogram (np.bincount) per
    slab along each axis, weighted by the slab's index."""
    seg = np.ascontiguousarray(seg)
    n = int(seg.max()) + 1
    sums = []
    for axis in range(3):
        hist = np.stack([np.bincount(np.take(seg, i, axis).ravel(), minlength=n)
                         for i in range(seg.shape[axis])])
        sums.append(np.arange(seg.shape[axis]) @ hist)
    return hist.sum(0), np.stack(sums, 1)


def extract_centroids(seg: np.ndarray) -> List[dict]:
    """Per-label centers of mass of a non-negative integer volume, dropping
    tiny end vertebrae (location_json_local.py:40-50: <8000 voxels for the
    max label, <6000 for the min label). The index sums are exact integers,
    so each centre equals the JAX package's np.mean(np.argwhere(seg ==
    label), 0) bit for bit; one pass of histograms replaces its two passes
    a label over the volume."""
    counts, sums = _label_moments(seg)
    labels = np.flatnonzero(counts)
    labels = labels[labels != 0]
    out = []
    for label in labels:
        count = int(counts[label])
        if count < 8000 and label == labels.max():
            continue
        if count < 6000 and label == labels.min():
            continue
        c = sums[label] / count
        out.append({"label": int(label), "X": float(c[0]), "Y": float(c[1]), "Z": float(c[2])})
    out.sort(key=lambda e: e.get("label", 0))
    return out


def write_centroid_json(seg_path: str, json_path: str) -> List[dict]:
    seg = nifti.load(seg_path).get_fdata().astype(np.uint8)
    data = extract_centroids(seg)
    with open(json_path, "w") as f:
        json.dump(data, f, indent=4)
    return data


# ----------------------------------------------------------- full pipeline

_MASK_STRATEGIES = {
    "rect": extract_mask_volume,  # default: per-slice min-area-rect of the cleaned body
    "left": extract_mask_volume_left,
    "3d": extract_mask_3dvolume,
}


def process_mask3d(
    ct_path: str,
    label_path: str,
    json_path: str,
    vertebrae_ids: Sequence[int],
    output_folder: str,
    outputsize=(256, 256, 64),
    mask_mode: str = "rect",
    reorient: str = None,
    device="cuda",
):
    """Straighten one patient and emit per-vertebra CT/label/mask_2d crops
    (straighten_mask_3d.py:463-562). mask_mode selects the de-pedicle mask
    strategy (rect | left | 3d, see _MASK_STRATEGIES); reorient='RAI' first
    brings both volumes to that axis order (reorient_to,
    straighten_mask_3d.py:45-57 — real-world NIfTIs are not always RAI).
    The two resamples run on `device`."""
    extract_mask = _MASK_STRATEGIES[mask_mode]
    with open(json_path) as f:
        data = json.load(f)
    ct_img = nifti.load(ct_path)
    label_img = nifti.load(label_path)
    if reorient:
        ct_img = nifti.reorient_to(ct_img, tuple(reorient.upper()))
        label_img = nifti.reorient_to(label_img, tuple(reorient.upper()))
    ct_data = ct_img.get_fdata()
    label_data = label_img.get_fdata()

    coordinates = [
        [e["X"], e["Y"], e["Z"]] for e in data if isinstance(e, dict) and "X" in e
    ]
    basename = os.path.basename(ct_path).replace(".nii.gz", "")
    ct_data = window(ct_data, -300, 800)
    shape = (128, 128)

    inter = None
    if len(coordinates) == 1:
        straight_ct, straight_label = ct_data, label_data
    else:
        curve = extend_curve(np.array(coordinates), 20, (0, 0, 0), label_data.shape)
        inter = Interpolator(curve, step=1, get_local_basis=sagittal_basis)
        straight_ct = inter.interpolate_along(ct_data, shape, order=1, device=device)
        straight_label = inter.interpolate_along(label_data, shape, order=0, device=device)

    straight_label = remove_spine_labels_after_split(straight_label)

    # the crops are gzipped on a thread pool (zlib releases the GIL)
    outputs, writes = [], []
    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as io:
        for label in vertebrae_ids:
            dirs = {
                k: os.path.join(output_folder, k) for k in ("CT", "label", "mask_2d")
            }
            for d in dirs.values():
                os.makedirs(d, exist_ok=True)
            centroid = None
            for entry in data:
                if entry.get("label") == label:
                    centroid = (entry["X"], entry["Y"], entry["Z"])
                    if inter is not None:
                        centroid = inter.global_to_local(centroid, shape=shape)
            if centroid is None:
                continue
            ct_crop = extract_3d_volume(straight_ct, centroid, size=outputsize)
            lb_crop = extract_3d_volume(straight_label, centroid, size=outputsize)
            mask_crop = extract_mask(lb_crop, label)
            for kind, vol in (("CT", ct_crop), ("label", lb_crop), ("mask_2d", mask_crop)):
                p = os.path.join(dirs[kind], f"{basename}_{label}.nii.gz")
                writes.append(io.submit(
                    nifti.save, nifti.Nifti1Image(np.asarray(vol, np.float32), ct_img.affine), p))
            outputs.append(f"{basename}_{label}")
        for w in writes:
            w.result()
    return outputs


def process_data(data_folder: str, data: Dict, output_folder: str, outputsize=(256, 256, 64),
                 mask_mode: str = "rect", reorient: str = None, device="cuda"):
    """Walk {category: {patient: [vert_ids]}} (straighten_mask_3d.py:574-621)."""
    done = []
    for category, patients in data.items():
        for patient_id, vertebrae_ids in patients.items():
            pdir = os.path.join(data_folder, patient_id)
            ct = os.path.join(pdir, f"{patient_id}.nii.gz")
            msk = os.path.join(pdir, f"{patient_id}_msk.nii.gz")
            if not os.path.exists(msk):
                msk = os.path.join(pdir, f"{patient_id}_seg.nii.gz")
            js = os.path.join(pdir, f"{patient_id}.json")
            if not all(os.path.exists(p) for p in (ct, msk, js)):
                continue
            done += process_mask3d(ct, msk, js, vertebrae_ids, output_folder, outputsize,
                                   mask_mode=mask_mode, reorient=reorient, device=device)
    return done
