"""Plain reference of the iterative two-stage 3D synthesis: heal the upper
neighbour, then the lower neighbour on that output, then the target on the
twice-healed context, over the central 4/5 of each vertebra's slices.

The published eval_3d_sagittal_twostage.py written out plainly: numpy for
the band geometry and the paste-back (SHRM), the plain float32 generator
of `model.py` for the forwards, in batches of whole slices with no padding,
no window crop and no device-side band building. The target pass always
runs (the published script ran it only where the lower neighbour was
missing, which left stale slices behind; the system under test and this
reference both run it everywhere).
"""

from __future__ import annotations

import math

import numpy as np
import torch
from scipy.ndimage import label as cc_label

MAXHEIGHT = 40


def remove_small_cc(arr, min_size):
    """Zero the 8-connected components smaller than min_size."""
    lab, n = cc_label(arr, np.ones((3, 3), np.int32))
    if n == 0:
        return arr
    sizes = np.bincount(lab.ravel())
    out = arr.copy()
    out[np.isin(lab, np.nonzero(sizes < min_size)[0]) & (lab > 0)] = 0
    return out


def geometry(label_sl, vid):
    """(x1, x2, height, min_x, max_x) of vertebra `vid` in a slice, or None."""
    vert = remove_small_cc((label_sl == vid).astype(np.float64), 50)
    rows = np.argwhere(vert)[:, 0]
    if rows.size == 0:
        return None
    x1, x2 = int(rows.min()), int(rows.max())
    height = x2 - x1
    if height > MAXHEIGHT:
        x1 = int(rows.mean()) - 20
        x2 = x1 + 40
    h = label_sl.shape[0]
    mid = (x1 + x2) // 2
    if mid <= MAXHEIGHT // 2:
        min_x = 0
    elif h - mid <= MAXHEIGHT / 2:
        min_x = h - MAXHEIGHT
    else:
        min_x = mid - MAXHEIGHT // 2
    return x1, x2, height, min_x, min_x + MAXHEIGHT


def band(img, x1, x2, min_x, max_x):
    """Rows above the band from above the vertebra, rows below it from below."""
    h = img.shape[0]
    out = np.zeros_like(img)
    out[:min_x] = img[x1 - min_x:x1]
    tail = img[x2:x2 + h - max_x]
    out[max_x:max_x + tail.shape[0]] = tail
    return out


def generate(gen, jobs, device, batch):
    """(fake uint8 CT, binary seg, predicted height) of each job's slice."""
    outs = []
    for i in range(0, len(jobs), batch):
        part = jobs[i:i + batch]
        ctx = np.stack([j["ctx"] for j in part]).astype(np.float32)
        mask = np.stack([j["mask"] for j in part]).astype(np.float32)
        cam = np.stack([j["cam"] for j in part]).astype(np.float32)
        ratio = np.array([j["ratio"] for j in part], np.float32)
        t = lambda a: torch.from_numpy(a).to(device)[..., None] if a.ndim == 3 \
            else torch.from_numpy(a).to(device)
        with torch.no_grad():
            out = gen(t(ctx / 255.0 * 2.0 - 1.0), t(mask), 1.0 - t(cam / 255.0), t(ratio))
        fake = torch.round((out.x_stage2[..., 0] + 1.0) * 127.5).to(torch.uint8).cpu().numpy()
        seg = (out.fine_seg[..., 0] > 0.5).cpu().numpy().astype(np.float64)
        ph = (out.pred2_h * MAXHEIGHT).cpu().numpy()
        outs.extend(zip(fake, seg, ph))
    return outs


def paste(job, fake, seg, pred_h, ct_sl, label_sl, vid):
    """SHRM paste-back of one slice: (new CT slice, new label slice)."""
    x1, x2, height = job["x1"], job["x2"], job["height"]
    h = ct_sl.shape[0]
    ph = max(math.ceil(float(pred_h)), height)
    hd = ph - height
    x_upper = x1 - hd // 2
    x_bottom = x_upper + ph
    ori = job["ct_u8"].astype(np.float64)
    ct = np.zeros_like(ct_sl, np.float64)
    lb = np.zeros_like(label_sl, np.float64)
    if x_bottom > x_upper >= 0:
        ct[x_upper:x_bottom] = fake[x_upper:x_bottom]
        lb[x_upper:x_bottom] = seg[x_upper:x_bottom] * vid
    ct[:x_upper] = ((ori[hd // 2:x1] / 255.0 * 2 - 1) + 1) * 127.5
    tail = ori[x2:x2 + h - x_bottom]
    ct[x_bottom:x_bottom + tail.shape[0]] = tail
    lb[:x_upper] = label_sl[hd // 2:x1]
    ltail = label_sl[x2:x2 + h - x_bottom]
    lb[x_bottom:x_bottom + ltail.shape[0]] = ltail
    return ct, lb


def synthesize(gen, volumes, device, batch=64, axis=2):
    """[(ct_fake, label_fake)] of [(ct, labels, vertebra id, cam)] volumes,
    zero outside each vertebra's processed slices."""
    take = (lambda v, z: v[:, :, z]) if axis == 2 else (lambda v, z: v[:, z, :])
    preps = []
    for ct, labels, vid, cam in volumes:
        other = (0, 1) if axis == 2 else (0, 2)
        zs = np.nonzero((labels == vid).any(axis=other))[0]
        if zs.size == 0:
            preps.append(None)
            continue
        n = int(zs.max()) - int(zs.min()) + 1
        keep = int(n * 4 / 5)
        z0 = int(zs.min()) + (n - keep) // 2
        zl = list(range(z0, z0 + keep))
        center = (zl[0] + zl[-1]) // 2
        preps.append(dict(
            vid=vid, labels=labels, z=zl,
            ratio={z: abs(z - center) / n * 2 for z in zl},
            ct={z: take(ct, z).astype(np.float64) for z in zl},
            lb={z: take(labels, z).astype(np.float64) for z in zl},
            cam={z: (take(cam, z) * 255).astype(np.uint8) for z in zl}))
    for nb, which in ((-1, "upper"), (+1, "lower"), (0, "target")):
        jobs = []
        for p in preps:
            if p is None:
                continue
            vid = p["vid"] + nb
            for z in p["z"]:
                present = np.sum(take(p["labels"], z) == vid) > 200
                if (which == "upper" and not (p["vid"] > 8 and present)) or \
                        (which == "lower" and not (p["vid"] < 24 and present)):
                    continue
                g = geometry(p["lb"][z], vid)
                if g is None:
                    continue
                x1, x2, height, min_x, max_x = g
                ct_u8 = p["ct"][z].astype(np.uint8)
                mask = np.zeros(ct_u8.shape, np.uint8)
                mask[min_x:max_x + 1] = 1
                jobs.append(dict(p=p, z=z, vid=vid, x1=x1, x2=x2, height=height,
                                 ct_u8=ct_u8, ratio=p["ratio"][z], mask=mask,
                                 ctx=band(ct_u8, x1, x2, min_x, max_x),
                                 cam=band(p["cam"][z], x1, x2, min_x, max_x)))
        for j, (fake, seg, ph) in zip(jobs, generate(gen, jobs, device, batch)):
            p, z = j["p"], j["z"]
            p["ct"][z], p["lb"][z] = paste(j, fake, seg, ph, p["ct"][z], p["lb"][z], j["vid"])
    results = []
    for (ct, *_), p in zip(volumes, preps):
        ct_fake = np.zeros(ct.shape, np.float64)
        lb_fake = np.zeros(ct.shape, np.float64)
        if p is not None:
            for z in p["z"]:
                if axis == 2:
                    ct_fake[:, :, z], lb_fake[:, :, z] = p["ct"][z], p["lb"][z]
                else:
                    ct_fake[:, z, :], lb_fake[:, z, :] = p["ct"][z], p["lb"][z]
        results.append((ct_fake, lb_fake))
    return results


def count_jobs(volumes, axis=2):
    """The generator slices a patient needs: for each volume, the processed
    slices where the upper and the lower neighbour are present (over 200
    voxels) and found, and those where the target is found, read from the
    original labels."""
    take = (lambda v, z: v[:, :, z]) if axis == 2 else (lambda v, z: v[:, z, :])
    n = 0
    for _, labels, vid, _ in volumes:
        other = (0, 1) if axis == 2 else (0, 2)
        zs = np.nonzero((labels == vid).any(axis=other))[0]
        if zs.size == 0:
            continue
        ext = int(zs.max()) - int(zs.min()) + 1
        keep = int(ext * 4 / 5)
        z0 = int(zs.min()) + (ext - keep) // 2
        for z in range(z0, z0 + keep):
            sl = take(labels, z)
            for nb, allowed in ((-1, vid > 8), (+1, vid < 24)):
                if allowed and np.sum(sl == vid + nb) > 200 and geometry(sl, vid + nb):
                    n += 1
            n += geometry(sl, vid) is not None
    return n
