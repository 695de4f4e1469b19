"""Optical-flow RGB visualization for contextual-attention offsets.

A copy of healthivert_tpu/ops/flow_viz.py:17-93 (numpy). Parity with reference models/inpaint_tools.py:73-100,178-273
(flow_to_image / compute_color / make_color_wheel): offsets minus the
identity grid, radius-normalized, mapped through the Middlebury color wheel.

In the reference this runs on CPU inside the hot forward pass
(inpaint_networks.py:399) forcing a device sync every step; here it is a
debug utility called only on demand with offsets already on host.
"""

from __future__ import annotations

import numpy as np


def make_color_wheel() -> np.ndarray:
    ry, yg, gc, cb, bm, mr = 15, 6, 4, 11, 13, 6
    ncols = ry + yg + gc + cb + bm + mr
    wheel = np.zeros((ncols, 3))
    col = 0
    wheel[0:ry, 0] = 255
    wheel[0:ry, 1] = np.floor(255 * np.arange(ry) / ry)
    col += ry
    wheel[col : col + yg, 0] = 255 - np.floor(255 * np.arange(yg) / yg)
    wheel[col : col + yg, 1] = 255
    col += yg
    wheel[col : col + gc, 1] = 255
    wheel[col : col + gc, 2] = np.floor(255 * np.arange(gc) / gc)
    col += gc
    wheel[col : col + cb, 1] = 255 - np.floor(255 * np.arange(cb) / cb)
    wheel[col : col + cb, 2] = 255
    col += cb
    wheel[col : col + bm, 2] = 255
    wheel[col : col + bm, 0] = np.floor(255 * np.arange(bm) / bm)
    col += bm
    wheel[col : col + mr, 2] = 255 - np.floor(255 * np.arange(mr) / mr)
    wheel[col : col + mr, 0] = 255
    return wheel


def compute_color(u: np.ndarray, v: np.ndarray) -> np.ndarray:
    h, w = u.shape
    img = np.zeros((h, w, 3))
    nan_idx = np.isnan(u) | np.isnan(v)
    u = np.where(nan_idx, 0, u)
    v = np.where(nan_idx, 0, v)
    wheel = make_color_wheel()
    ncols = wheel.shape[0]
    rad = np.sqrt(u**2 + v**2)
    a = np.arctan2(-v, -u) / np.pi
    fk = (a + 1) / 2 * (ncols - 1) + 1
    k0 = np.floor(fk).astype(int)
    k1 = k0 + 1
    k1[k1 == ncols + 1] = 1
    f = fk - k0
    for i in range(3):
        col0 = wheel[(k0 - 1) % ncols, i] / 255.0
        col1 = wheel[(k1 - 1) % ncols, i] / 255.0
        col = (1 - f) * col0 + f * col1
        idx = rad <= 1
        col[idx] = 1 - rad[idx] * (1 - col[idx])
        col[~idx] *= 0.75
        img[:, :, i] = np.uint8(np.floor(255 * col * (1 - nan_idx)))
    return img


def flow_to_image(flow: np.ndarray) -> np.ndarray:
    """flow: (B, H, W, 2) float. Returns (B, H, W, 3) float32 in [0, 255]."""
    out = []
    maxrad = -1.0
    flow = np.array(flow, np.float64)
    for i in range(flow.shape[0]):
        u, v = flow[i, :, :, 0], flow[i, :, :, 1]
        unknown = (np.abs(u) > 1e7) | (np.abs(v) > 1e7)
        u[unknown] = 0
        v[unknown] = 0
        maxrad = max(maxrad, float(np.sqrt(u**2 + v**2).max()))
        out.append((u, v))
    eps = np.finfo(float).eps
    return np.float32(
        np.uint8([compute_color(u / (maxrad + eps), v / (maxrad + eps)) for u, v in out])
    )


def offsets_to_flow_image(offsets: np.ndarray, upscale: int = 8) -> np.ndarray:
    """Attention argmax coords (B, h, w, 2) -> RGB flow image in [0, 1],
    nearest-upsampled by `upscale` (rate*4, inpaint_networks.py:389-408)."""
    b, h, w, _ = offsets.shape
    iy, ix = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    ref = np.stack([iy, ix], -1)[None]
    flow = flow_to_image(offsets.astype(np.float64) - ref) / 255.0
    return flow.repeat(upscale, axis=1).repeat(upscale, axis=2)
