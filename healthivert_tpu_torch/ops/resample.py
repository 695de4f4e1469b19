"""PIL's separable image resampling, in numpy (the card's machine has no
PIL).

Pillow's Resample.c resizes in two passes, horizontal then vertical, each
only where the size changes. Per output pixel it takes the filter's taps
around the pixel's centre in the input, (xx + 0.5) * in / out, with the
support widened by the scale when downscaling, and normalises them to sum
1 (`coefficients`, its precompute_coeffs). Then:
- a float image (mode "F") sums the taps' products in double, in tap order,
  and stores float32: no rounding to integers, no clipping
  (`resample_float`);
- an 8-bit image rounds the weights to 22-bit fixed point, sums in
  integers and clips to 0-255 (`resample_uint8`).
NEAREST is not a filter there: its source pixel is floor((x + 0.5) * in /
out), the position advanced by in / out from pixel to pixel
(ImagingScaleAffine), `nearest_index`.
"""

from __future__ import annotations

import math

import numpy as np

PRECISION_BITS = 32 - 8 - 2  # the 8-bit path's fixed point


def _bilinear(x):
    x = np.abs(x)
    return np.where(x < 1.0, 1.0 - x, 0.0)


def _bicubic(x):
    """PIL's BICUBIC kernel, a = -0.5."""
    a = -0.5
    x = np.abs(x)
    return np.where(x < 1.0, ((a + 2.0) * x - (a + 3.0)) * x * x + 1,
                    np.where(x < 2.0, (((x - 5) * x + 8) * x - 4) * a, 0.0))


def _sinc(x):
    with np.errstate(invalid="ignore", divide="ignore"):
        px = x * math.pi
        return np.where(x == 0.0, 1.0, np.sin(px) / px)


def _lanczos(x):
    return np.where((-3.0 <= x) & (x < 3.0), _sinc(x) * _sinc(x / 3), 0.0)


# name -> (kernel, support)
FILTERS = {"bilinear": (_bilinear, 1.0), "bicubic": (_bicubic, 2.0),
           "lanczos": (_lanczos, 3.0)}


def coefficients(in_size: int, out_size: int, method: str):
    """(xmin, weights): each output pixel's first input tap (out,) and its
    normalised weights (out, ksize) in float64, zero past its last tap."""
    kernel, support = FILTERS[method]
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = support * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    # C's (int) cast truncates toward zero
    xmin = np.maximum(np.trunc(center - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum(np.trunc(center + support + 0.5).astype(np.int64), in_size) - xmin
    taps = np.arange(ksize)
    w = kernel(((taps[None, :] + xmin[:, None]) - center[:, None] + 0.5) * (1.0 / filterscale))
    w = np.where(taps[None, :] < xmax[:, None], w, 0.0)
    ww = np.zeros(out_size)
    for j in range(ksize):  # the sum in C's order
        ww = ww + w[:, j]
    w = np.where(ww[:, None] != 0.0, w / np.where(ww == 0.0, 1.0, ww)[:, None], w)
    return xmin, w


def _taps(in_size, xmin, ksize):
    return np.minimum(xmin[:, None] + np.arange(ksize)[None, :], in_size - 1)


def resample_float(arr: np.ndarray, out_size: int, axis: int, method: str) -> np.ndarray:
    """One pass of mode "F" along `axis`: float32 in and out, the products
    summed in float64 in tap order."""
    moved = np.moveaxis(np.asarray(arr, np.float32), axis, 0).astype(np.float64)
    xmin, w = coefficients(moved.shape[0], out_size, method)
    idx = _taps(moved.shape[0], xmin, w.shape[1])
    expand = (slice(None),) + (None,) * (moved.ndim - 1)
    ss = np.zeros((out_size,) + moved.shape[1:])
    for j in range(w.shape[1]):
        ss = ss + moved[idx[:, j]] * w[:, j][expand]
    return np.moveaxis(ss.astype(np.float32), 0, axis)


def resample_uint8(arr: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One bicubic pass of the 8-bit path along `axis`: the weights in fixed
    point (C's (int) cast of w * 2^22 +- 0.5), integer sums, clipped to
    uint8."""
    moved = np.moveaxis(arr, axis, 0).astype(np.int64)
    xmin, w = coefficients(moved.shape[0], out_size, "bicubic")
    k = np.trunc(np.where(w < 0, -0.5, 0.5) + w * (1 << PRECISION_BITS)).astype(np.int64)
    idx = _taps(moved.shape[0], xmin, k.shape[1])
    expand = (slice(None),) + (None,) * (moved.ndim - 1)
    ss = np.full((out_size,) + moved.shape[1:], 1 << (PRECISION_BITS - 1), np.int64)
    for j in range(k.shape[1]):
        ss += moved[idx[:, j]] * k[:, j][expand]
    return np.moveaxis(np.clip(ss >> PRECISION_BITS, 0, 255).astype(np.uint8), 0, axis)


def nearest_index(in_size: int, out_size: int) -> np.ndarray:
    """PIL NEAREST's source pixel of each output pixel."""
    step = in_size / out_size
    pos = np.empty(out_size)
    x = step * 0.5
    for i in range(out_size):  # the position is advanced, not multiplied
        pos[i] = x
        x += step
    return np.minimum(np.where(pos < 0.0, -1, np.trunc(pos)).astype(np.int64), in_size - 1)


def resize(img: np.ndarray, out_h: int, out_w: int, method: str = "bicubic") -> np.ndarray:
    """PIL's ``Image.fromarray(img.astype(float32), "F").resize((out_w,
    out_h), method)`` of an (H, W) array: float32, horizontal then
    vertical."""
    out = np.asarray(img, np.float32)
    if method == "nearest":
        return out[np.ix_(nearest_index(out.shape[0], out_h), nearest_index(out.shape[1], out_w))]
    if out.shape[1] != out_w:
        out = resample_float(out, out_w, 1, method)
    if out.shape[0] != out_h:
        out = resample_float(out, out_h, 0, method)
    return out
