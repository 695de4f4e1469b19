"""Legacy axial-plane mask extraction (reference C22).

Counterpart of healthivert_tpu/straighten/axial.py, host numpy only
(reference data/mask_extract.py:16-175): the earlier data
strategy the straightened pipeline replaced — vertebra-body isolation by
connected components on the mid-axial slice (drop the posterior processes),
a 1.2x-scaled minimum-area rectangle mask, and 224^2 center crops. Imported
but never called by the live reference pipeline (aligned_dataset.py:8);
provided here so the axial strategy remains available. Uses the native
geometry kernels instead of OpenCV/skimage.
"""

from __future__ import annotations

import numpy as np

from ..ops import native_geometry as ng
from .pipeline import window


def _dilate2(seg: np.ndarray) -> np.ndarray:
    """skimage.morphology.dilation with square(2): max over the 2x2 window
    whose anchor is the bottom-right pixel (footprint offsets {-1, 0})."""
    p = np.pad(seg, ((1, 0), (1, 0)))
    h, w = seg.shape
    return np.maximum.reduce(
        [p[1:, 1:], p[:-1, 1:], p[1:, :-1], p[:-1, :-1]]
    )[:h, :w]


def get_vertbody(seg0: np.ndarray):
    """Isolate the vertebral body component (mask_extract.py:16-52).

    Components are ranked by size; the body is the largest unless the
    second-largest lies further anterior (smaller min-column) and is big
    enough (>= 30 px), mirroring the reference's tie-break. Returns
    (60x60 crop, body mask, center (row, col))."""
    seg = _dilate2(seg0)
    labels, num = ng.cc_label((seg > 0).astype(np.uint8))
    if num == 0:
        return np.zeros((60, 60)), np.zeros_like(seg0), np.array([0.0, 0.0])
    locs = [np.where(labels == i) for i in range(1, num + 1)]
    count = [l[0].shape[0] for l in locs]
    y = [int(min(l[1])) for l in locs]
    if num == 1:
        best = 0
    else:
        order = np.argsort(np.array(count))
        if y[order[-1]] < y[order[-2]] or count[order[-2]] < 30:
            best = order[-1]
        else:
            best = order[-2]
    out = np.zeros(labels.shape)
    out[locs[best]] = 1
    xs, ys = locs[best]
    out = out * seg0
    out2 = np.zeros((60, 60))
    out2[2 : 3 + xs.max() - xs.min(), 2 : 3 + ys.max() - ys.min()] = out[
        xs.min() : xs.max() + 1, ys.min() : ys.max() + 1
    ]
    return out2, out, np.array([xs.mean(), ys.mean()])


def process_spine_data(ct_data, label_data, label_id: int, output_size=(224, 224)):
    """Axial mid-slice crop + de-process mask (mask_extract.py:70-191).

    Returns dict with the output_size CT/label center crops, the 1.2x
    min-area-rect mask, and the masked slices — ALL cropped to output_size
    through the same center window, like the reference's returns
    (mask_extract.py:177-191). Returns None when no vertebral-body
    component survives isolation (the reference crashes on an empty
    contour list there). Like the reference, only output_size[0] is used
    (square crops); non-square sizes are rejected."""
    if output_size[0] != output_size[1]:
        raise ValueError("process_spine_data crops are square (reference "
                         f"uses output_size[0] only); got {output_size}")
    label = int(label_id)
    binary_label = np.where(label_data != 0, 255.0, 0.0)
    ct_data = window(ct_data.astype(np.float64), -300, 800)

    loc = np.where(label_data == label)
    center_z = int(np.mean(loc[2]))
    z0, z1 = int(loc[0].min()), int(loc[0].max())
    y0, y1 = int(loc[1].min()), int(loc[1].max())

    label_binary = np.zeros(label_data.shape)
    label_binary[loc] = 1
    img2d = label_binary[z0 : z1 + 1, y0 : y1 + 1, center_z]
    _, body, _ = get_vertbody(img2d)

    pts = np.where(body == 1)
    if pts[0].size == 0:
        # num==0 in get_vertbody, or the seg0 intersection erased the
        # selected component (dilation-bridged pixels only)
        return None
    aligned = np.zeros_like(label_data[:, :, 0], np.uint8)
    aligned[pts[0] + z0, pts[1] + y0] = 1
    center_y = int(np.mean(pts[0]) + z0)
    center_x = int(np.mean(pts[1]) + y0)

    center_slice = ct_data[:, :, center_z].copy()
    center_label_slice = binary_label[:, :, center_z].copy()

    half = output_size[0] // 2
    min_y = max(0, half - center_y)
    max_y = min(output_size[0], half + (center_slice.shape[0] - center_y))
    min_x = max(0, half - center_x)
    max_x = min(output_size[0], half + (center_slice.shape[1] - center_x))

    def _crop(src):
        out = np.zeros(output_size, dtype=src.dtype)
        out[min_y:max_y, min_x:max_x] = src[
            max(center_y - half, 0) : min(center_y + half, src.shape[0]),
            max(center_x - half, 0) : min(center_x + half, src.shape[1]),
        ]
        return out

    # 1.2x-scaled min-area-rect of the body; other-vertebra pixels removed
    # for labels 8..25 only (mask_extract.py:160-168 — cervical labels stay)
    pts_xy = np.argwhere(aligned)[:, ::-1].astype(np.float64)
    corners, center = ng.min_area_rect(pts_xy)
    scaled = (corners - center) * 1.2 + center
    bbox = ng.fill_convex_quad(np.rint(scaled).astype(np.int32), aligned.shape, 255)
    lab_slice = label_data[:, :, center_z]
    other = (lab_slice != label) & (lab_slice >= 8) & (lab_slice <= 25)
    bbox[other] = 0

    masked_image = center_slice.copy()
    masked_image[bbox == 255] = 0
    masked_label = center_label_slice.copy()
    masked_label[bbox == 255] = 0
    return dict(
        ct_crop=_crop(center_slice),
        label_crop=_crop(center_label_slice),
        mask=_crop(bbox),
        masked_image=_crop(masked_image),
        masked_label=_crop(masked_label),
        center=(center_y, center_x),
        center_z=center_z,
    )
