"""The training batches of the synthetic recipe, worked out again from the
seed: the spines, the example cache and the batch draws of the system's
synthetic dataset (a copy of the upstream-derived fixture: four spines,
every other one with its middle vertebra compressed to 0.6; examples are
pyramid-weighted slices of the central 4/5 of a vertebra, with the 40-row
band and its shifted context; a batch draws examples from the cache).

One numpy generator, seeded with the run's seed, is drawn in the system's
order: the spines, then each cached example's vertebra and slice, then each
batch's cache indices. Only the draws are replayed for the whole cache; the
examples that the first batches use are then built in full.
"""

from __future__ import annotations

import numpy as np
from scipy.ndimage import label as cc_label

MAXHEIGHT = 40


def spine(rng, shape, vert_ids, vert_height, gap, fractured):
    """(ct, labels, cam) of one spine, drawing from rng as the fixture does."""
    h, w, z = shape
    ct = rng.normal(30, 8, shape)
    labels = np.zeros(shape, np.int16)
    cam = np.zeros(shape, np.float32)
    pitch = vert_height + gap
    start = (h - len(vert_ids) * pitch + gap) // 2
    rr, cc, zz = np.meshgrid(np.arange(h), np.arange(w), np.arange(z), indexing="ij")
    for i, vid in enumerate(vert_ids):
        c_row = start + i * pitch + vert_height // 2
        frac = fractured.get(vid, 1.0)
        eff_h = vert_height * (frac + (1 - frac) * (cc / w)) / 2.0
        body = (np.abs(rr - c_row) <= eff_h) & (np.abs(cc - w * 0.5) <= w * 0.18) \
            & (np.abs(zz - z * 0.5) <= z * 0.42)
        labels[body] = vid
        ct[body] = 160 + 25 * np.sin(rr[body] / 3.0)
        if frac < 1.0:
            cam[body] = min(1.0, (1 - frac) * 1.5)
    ct = np.clip(ct + rng.normal(0, 4, shape), 0, 255)
    return ct, labels, cam


def clean(arr, min_size=50):
    """Zero the 8-connected components smaller than min_size."""
    lab, n = cc_label(arr, np.ones((3, 3), np.int32))
    if n == 0:
        return arr
    sizes = np.bincount(lab.ravel())
    out = arr.copy()
    out[np.isin(lab, np.nonzero(sizes < min_size)[0]) & (lab > 0)] = 0
    return out


def draw_slice(rng, labels, vid, z0, z1):
    """The fixture's slice choice: pyramid weights over the central 4/5 of
    [z0, z1], retried until the cleaned slice has over 50 voxels and a
    height under MAXHEIGHT. (z, ratio, x1, x2), or None after 100 tries."""
    n = z1 - z0 + 1
    keep = int(n * 4 / 5) or n
    a = z0 + (n - keep) // 2
    b = a + keep - 1
    center = (a + b) // 2
    weights = np.array([1 - abs(i - center) / max(b - a, 1) for i in range(a, b + 1)])
    weights = weights / weights.sum()
    for _ in range(100):
        z = int(rng.choice(np.arange(a, b + 1), p=weights))
        ratio = abs(z - center) / n * 2
        sl = clean(labels[:, :, z] == vid)
        if sl.sum() > 50:
            rows = np.argwhere(sl)[:, 0]
            x1, x2 = int(rows.min()), int(rows.max())
            if x2 - x1 < MAXHEIGHT:
                return z, ratio, x1, x2
    return None


def shift(img, x1, x2, min_x, max_x):
    h = img.shape[0]
    out = np.zeros_like(img)
    out[:min_x] = img[x1 - min_x:x1]
    tail = img[x2:x2 + h - max_x]
    out[max_x:max_x + tail.shape[0]] = tail
    return out


def example(vol, normal_ids, vid, z, ratio, x1, x2):
    """One training example (the fixture's dict) at a chosen slice."""
    ct, labels, cam = vol
    vert = labels[:, :, z] == vid
    vert = clean(vert)
    h = ct.shape[0]
    mid = (x1 + x2) // 2
    min_x = 0 if mid <= MAXHEIGHT // 2 else (h - MAXHEIGHT if h - mid <= MAXHEIGHT / 2
                                             else mid - MAXHEIGHT // 2)
    max_x = min_x + MAXHEIGHT
    full = ct[:, :, z].astype(np.float64)
    normal = np.isin(labels[:, :, z], list(normal_ids)).astype(np.float64)
    mask = np.zeros_like(full)
    mask[min_x:max_x] = 1
    unit = lambda a: a.astype(np.uint8).astype(np.float32) / 255.0
    return dict(
        full=unit(full)[..., None] * 2 - 1,
        context=unit(shift(full, x1, x2, min_x, max_x))[..., None] * 2 - 1,
        vert_seg=unit(vert * 255)[..., None],
        mask=unit(mask * 255)[..., None],
        normal_vert=unit(shift(normal, x1, x2, min_x, max_x) * 255)[..., None],
        cam=unit(shift(cam[:, :, z] * 255, x1, x2, min_x, max_x))[..., None],
        height=np.int32(x2 - x1), x1=np.int32(x1), x2=np.int32(x2),
        slice_ratio=np.float32(ratio))


def batches(seed, n_batches, batch_size, cache_size, crop_size=256, n_volumes=4, first=1):
    """n_batches training batches of the synthetic recipe, from the
    first-th on (the batch of step `first`, steps numbered from 1)."""
    rng = np.random.default_rng(seed)
    shape, ids, vh, gap = (256, 256, 64), (18, 19, 20, 21, 22), 26, 10
    if crop_size != 256:
        s = crop_size
        shape, ids = (s, s, max(16, s // 4)), ids[:max(1, s // 80 + 1)]
        vh, gap = max(10, s // 10), max(4, s // 25)
    vols, fractured = [], []
    for i in range(n_volumes):
        frac = {ids[len(ids) // 2]: 0.6} if i % 2 else {}
        vols.append(spine(rng, shape, ids, vh, gap, frac))
        fractured.append(set(frac))
    items = [(vi, int(v)) for vi, (_, lab, _) in enumerate(vols) for v in np.unique(lab)[1:]]
    extent = {}
    for vi, vid in items:
        zs = np.nonzero((vols[vi][1] == vid).any(axis=(0, 1)))[0]
        extent[vi, vid] = (int(zs.min()), int(zs.max()))
    cache = []
    while len(cache) < cache_size:
        vi, vid = items[rng.integers(len(items))]
        got = draw_slice(rng, vols[vi][1], vid, *extent[vi, vid])
        if got is not None:
            cache.append((vi, vid) + got)
    for _ in range(first - 1):
        rng.integers(cache_size, size=batch_size)
    out = []
    for _ in range(n_batches):
        idx = rng.integers(cache_size, size=batch_size)
        exs = []
        for i in idx:
            vi, vid, z, ratio, x1, x2 = cache[i]
            normal = [v for v in np.unique(vols[vi][1])[1:] if int(v) not in fractured[vi]]
            exs.append(example(vols[vi], normal, vid, z, ratio, x1, x2))
        out.append({k: np.stack([e[k] for e in exs]) for k in exs[0]})
    return out
