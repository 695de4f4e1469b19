"""The comparison that decides `correct`: the numbers held against their
limits, and the gaps between what the system produced and what the plain
reference computes again."""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch


def passed(checks: dict) -> bool:
    """True when every number compared is finite and within its limit."""
    return all(isinstance(v, (int, float)) and math.isfinite(v) and v <= lim
               for v, lim in checks.values())


@contextlib.contextmanager
def exact_float32(tf32=False):
    """float32 matmuls and convolutions without TF32, for the reference
    (tf32=True: with it, the float32 configuration's control)."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def processed(labels, vid, axis):
    """The slice indices the 3D synthesis processes for vertebra vid."""
    other = (0, 1) if axis == 2 else (0, 2)
    zs = np.nonzero((labels == vid).any(axis=other))[0]
    if zs.size == 0:
        return []
    n = int(zs.max()) - int(zs.min()) + 1
    keep = int(n * 4 / 5)
    z0 = int(zs.min()) + (n - keep) // 2
    return list(range(z0, z0 + keep))


def volume_gaps(got, want, volumes, axis):
    """Over the processed slices of a patient's volumes: the mean |CT
    difference| (CT units), the median over the slices of each slice's mean
    |CT difference|, and for the record the share of label voxels that
    differ and the share of CT voxels more than 8 apart."""
    take = (lambda v, z: v[:, :, z]) if axis == 2 else (lambda v, z: v[:, z, :])
    per_slice, mism, far, n = [], 0, 0, 0
    for (g_ct, g_lb), (w_ct, w_lb), (_, labels, vid, _) in zip(got, want, volumes):
        zl = processed(labels, vid, axis)
        if not zl:
            continue
        sel = lambda v: np.stack([take(v, z) for z in zl])
        d = np.abs(sel(g_ct).astype(np.float64) - sel(w_ct))
        per_slice += d.reshape(len(zl), -1).mean(axis=1).tolist()
        far += int((d > 8).sum())
        mism += int((sel(g_lb) != sel(w_lb)).sum())
        n += d.size
    n = max(n, 1)
    return {"ct_mad": float(np.mean(per_slice)) if per_slice else 0.0,
            "ct_slice_median": float(np.median(per_slice)) if per_slice else 0.0,
            "label_mismatch": mism / n, "ct_far_share": far / n}


def leaf_gap(got: dict, want: dict, skip=()):
    """Worst leaf's gap of norms: |norm(got) - norm(want)| over the larger
    of the reference leaf's norm and the median leaf's; (gap, leaf)."""
    keys = [k for k in want if k not in skip]
    if not keys:
        return float("nan"), None
    med = float(np.median([want[k] for k in keys]))
    worst = (0.0, None)
    for k in keys:
        g = abs(got[k] - want[k]) / max(want[k], med, 1e-30)
        if not math.isfinite(g):
            return float("inf"), k
        if g > worst[0]:
            worst = (g, k)
    return worst


def breakdown(window, top=10):
    """The contract's breakdown of a traced window: the device operations
    that took most time and the longest idle gaps by host span."""
    ops = sorted(window.kernels.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[k[:200], v] for k, v in ops],
            "idle_gaps": [[k, v] for k, v in window.gaps[:top]]}
