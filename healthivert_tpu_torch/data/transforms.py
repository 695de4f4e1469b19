"""Image transform factory, parity with the reference's
data/base_dataset.py.

Counterpart of healthivert_tpu/data/transforms.py. The live pipeline uses
--preprocess none, where the only active transform is power-of-4 size
rounding (base_dataset.py:82-114,117-127); resize/crop/flip variants are
provided for the other --preprocess modes. Works on numpy (H, W) float
arrays. The JAX package resizes through PIL's mode "F"; the card's machine
has no PIL, so `resize` is ops/resample.resize, PIL's float resample
written out in numpy (bicubic, bilinear, lanczos and nearest, equal to
PIL's). Shared-parameter pairs (params=) and the normalize flag mirror the
reference signature (base_dataset.py:64-115). Random draws come from the
`rng` numpy Generator a caller passes.
"""

from __future__ import annotations

import numpy as np

from ..ops import resample


def make_power_2(img: np.ndarray, base: int = 4, method: str = "bicubic") -> np.ndarray:
    """Round H, W to the nearest multiple of `base` via
    int(round(x / base) * base) and resize (base_dataset.py:117-127;
    reference default interpolation is BICUBIC)."""
    h, w = img.shape[:2]
    nh = int(round(h / base) * base)
    nw = int(round(w / base) * base)
    if (nh, nw) == (h, w):
        return img
    return resize(img, nh, nw, method)


def resize(img: np.ndarray, nh: int, nw: int, method: str = "bicubic") -> np.ndarray:
    """PIL's mode-"F" resample of `img` to (nh, nw) with `method` (bicubic,
    bilinear, nearest or lanczos), in numpy (ops/resample.py), as float64."""
    return np.asarray(resample.resize(img, nh, nw, method), np.float64)


def resize_bilinear(img: np.ndarray, nh: int, nw: int) -> np.ndarray:
    """Pure-numpy bilinear (kept for callers that need a PIL-free path)."""
    h, w = img.shape[:2]
    ys = (np.arange(nh) + 0.5) * h / nh - 0.5
    xs = (np.arange(nw) + 0.5) * w / nw - 0.5
    y0 = np.clip(np.floor(ys).astype(int), 0, h - 1)
    x0 = np.clip(np.floor(xs).astype(int), 0, w - 1)
    y1 = np.clip(y0 + 1, 0, h - 1)
    x1 = np.clip(x0 + 1, 0, w - 1)
    fy = np.clip(ys - y0, 0, 1)[:, None]
    fx = np.clip(xs - x0, 0, 1)[None, :]
    a = img[np.ix_(y0, x0)]
    b = img[np.ix_(y0, x1)]
    c = img[np.ix_(y1, x0)]
    d = img[np.ix_(y1, x1)]
    return (a * (1 - fy) * (1 - fx) + b * (1 - fy) * fx + c * fy * (1 - fx) + d * fy * fx)


def get_params(opt, size, rng: np.random.Generator | None = None) -> dict:
    """Shared crop/flip parameters for a paired transform (base_dataset.py:
    64-81). `size` is (w, h) like PIL's img.size."""
    rng = rng or np.random.default_rng()
    w, h = size
    new_w, new_h = w, h
    preprocess = getattr(opt, "preprocess", "none")
    load_size = getattr(opt, "load_size", 256)
    crop_size = getattr(opt, "crop_size", 256)
    if preprocess == "resize_and_crop":
        new_h = new_w = load_size
    elif preprocess == "scale_width_and_crop":
        new_w = load_size
        new_h = load_size * h // w
    x = int(rng.integers(0, max(0, new_w - crop_size) + 1))
    y = int(rng.integers(0, max(0, new_h - crop_size) + 1))
    return {"crop_pos": (x, y), "flip": bool(rng.random() > 0.5)}


def get_transform(opt, params=None, rng: np.random.Generator | None = None,
                  grayscale=True, method: str = "bicubic", convert=True,
                  normalize=True):
    """Compose the transform chain for --preprocess (base_dataset.py:82-114).
    Returns a callable numpy (H, W) -> (H, W) or normalized float array.
    With params (from get_params), crop position and flip are fixed so
    paired A/B images transform identically; normalize=False stops at the
    ToTensor-equivalent [0, 1] scaling (for masks)."""
    rng = rng or np.random.default_rng()
    preprocess = getattr(opt, "preprocess", "none")
    load_size = getattr(opt, "load_size", 256)
    crop_size = getattr(opt, "crop_size", 256)
    no_flip = getattr(opt, "no_flip", False)

    def apply(img: np.ndarray) -> np.ndarray:
        out = np.asarray(img, np.float64)
        if "resize" in preprocess:
            out = resize(out, load_size, load_size, method)
        elif "scale_width" in preprocess:
            h, w = out.shape[:2]
            nw = load_size
            nh = max(int(load_size * h / w), crop_size)
            out = resize(out, nh, nw, method)
        if "crop" in preprocess:
            h, w = out.shape[:2]
            if params is None:
                y = int(rng.integers(0, max(h - crop_size, 0) + 1))
                x = int(rng.integers(0, max(w - crop_size, 0) + 1))
            else:
                x, y = params["crop_pos"]
            out = out[y : y + crop_size, x : x + crop_size]
        if preprocess == "none":
            out = make_power_2(out, base=4, method=method)
        if not no_flip:
            flip = params["flip"] if params is not None else rng.random() > 0.5
            if flip:
                out = out[:, ::-1]
        if convert:
            out = out.astype(np.float32) / 255.0
            if normalize:
                out = out * 2.0 - 1.0
        return out

    return apply
