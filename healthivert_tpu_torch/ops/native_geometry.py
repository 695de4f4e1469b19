"""ctypes binding of the host geometry kernels of the de-pedicle masks.

Counterpart of healthivert_tpu/ops/native_geometry.py: connected
components, the minimum-area rectangle (rotating calipers) and the
convex-quad scanline fill that replace the reference's OpenCV calls
(straighten_mask_3d.py:365-436). The C++ source is the repository's
native/geometry.cpp (`cc_label` :24, `min_area_rect` :107,
`fill_convex_quad` :173). It is compiled at first use with g++ into
healthivert_tpu_torch/_build/, named by a hash of the source and the flags,
and there is no fallback: a failed build raises with the compiler's
message. The plain numpy versions (`cc_label_reference`,
`min_area_rect_reference`, `fill_convex_quad_reference`), copies of the
JAX binding's fallbacks, are what the tests hold the library to.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG.parent / "native" / "geometry.cpp"
BUILD_DIR = _PKG / "_build"
CXX_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17"]  # those of native/Makefile

_lib = None
# the straightening pipeline's loaders may run in host threads: the first
# calls must not race a build against a library half written
_lock = threading.Lock()


def build() -> Path:
    """Compile SOURCE into BUILD_DIR unless the library of this source and
    these flags is there; written under a temporary name and renamed, so a
    concurrent process never loads half a file. Raises with g++'s message."""
    digest = hashlib.sha1(" ".join(CXX_FLAGS).encode() + SOURCE.read_bytes()).hexdigest()[:16]
    out = BUILD_DIR / f"hv_geometry_{digest}.so"
    if out.exists():
        return out
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        raise RuntimeError("native geometry: no C++ compiler (g++, or $CXX) on PATH")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"{out.stem}.tmp{os.getpid()}.{threading.get_ident()}.so"
    proc = subprocess.run([cxx, *CXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"native geometry: {cxx} failed ({proc.returncode}) on {SOURCE}:\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def load_library():
    """Build (if needed) and load the library once per process."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.cc_label.restype = ctypes.c_int
            lib.cc_label.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
            lib.min_area_rect.restype = None
            lib.min_area_rect.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                                          ctypes.c_void_p]
            lib.fill_convex_quad.restype = None
            lib.fill_convex_quad.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                             ctypes.c_uint8, ctypes.c_void_p]
            _lib = lib
    return _lib


def cc_label(img: np.ndarray):
    """8-connected components of a binary (h, w) image -> (labels int32,
    count), numbered in raster order of each component's first pixel."""
    img = np.ascontiguousarray(img != 0, np.uint8)
    h, w = img.shape
    labels = np.zeros((h, w), np.int32)
    n = load_library().cc_label(img.ctypes.data, h, w, labels.ctypes.data)
    return labels, n


def min_area_rect(points: np.ndarray):
    """points (n, 2) as (x, y) -> (corners (4, 2), center (2,)), float64:
    the minimum-area rectangle enclosing the points. Raises on no points."""
    pts = np.ascontiguousarray(points, np.float64)
    if pts.size == 0:
        raise ValueError("min_area_rect: empty point set")
    if pts.ndim != 2 or pts.shape[1] != 2:
        raise ValueError(f"min_area_rect: points of shape (n, 2) expected, got {pts.shape}")
    out = np.zeros(10, np.float64)
    xs, ys = np.ascontiguousarray(pts[:, 0]), np.ascontiguousarray(pts[:, 1])
    load_library().min_area_rect(xs.ctypes.data, ys.ctypes.data, len(pts), out.ctypes.data)
    return out[:8].reshape(4, 2), out[8:10]


def fill_convex_quad(corners: np.ndarray, shape, value: int = 255) -> np.ndarray:
    """Rasterise 4 (x, y) corners, rounded to the nearest integer, into a
    (h, w) uint8 image of `value` on 0."""
    h, w = shape
    c = np.ascontiguousarray(np.rint(corners), np.int32)
    if c.shape != (4, 2):
        raise ValueError(f"fill_convex_quad: corners of shape (4, 2) expected, got {c.shape}")
    img = np.zeros((h, w), np.uint8)
    load_library().fill_convex_quad(c.ctypes.data, h, w, np.uint8(value), img.ctypes.data)
    return img


# ------------------------------------------------------------ plain versions
# Copies of the JAX binding's numpy fallbacks (native_geometry.py:84-196).


def cc_label_reference(img: np.ndarray):
    """scipy's 8-connected `label`: the same components, numbered as the
    library numbers them."""
    from scipy.ndimage import label

    return label(np.ascontiguousarray(img != 0, np.uint8), np.ones((3, 3), np.int32))


def min_area_rect_reference(points: np.ndarray):
    """Rotating calipers over scipy's convex hull, in numpy."""
    from scipy.spatial import ConvexHull

    pts = np.ascontiguousarray(points, np.float64)
    if pts.size == 0:
        raise ValueError("min_area_rect: empty point set")
    if len(pts) == 1:
        c = pts[0]
        return np.tile(c, (4, 1)), c.copy()
    uniq = np.unique(pts, axis=0)
    if len(uniq) < 3 or np.linalg.matrix_rank(uniq - uniq[0]) < 2:
        hull = uniq
    else:
        hull = uniq[ConvexHull(uniq).vertices]
    best = None
    for i in range(len(hull)):
        e = hull[(i + 1) % len(hull)] - hull[i]
        n = np.linalg.norm(e)
        if n < 1e-12:
            continue
        e = e / n
        nrm = np.array([-e[1], e[0]])
        pe = hull @ e
        pn = hull @ nrm
        area = (pe.max() - pe.min()) * (pn.max() - pn.min())
        if best is None or area < best[0]:
            corners = np.array([
                pe.min() * e + pn.min() * nrm,
                pe.max() * e + pn.min() * nrm,
                pe.max() * e + pn.max() * nrm,
                pe.min() * e + pn.max() * nrm,
            ])
            center = (pe.min() + pe.max()) / 2 * e + (pn.min() + pn.max()) / 2 * nrm
            best = (area, corners, center)
    if best is None:  # every hull edge degenerate: the points coincide
        mn, mx = pts.min(0), pts.max(0)
        corners = np.array([mn, [mx[0], mn[1]], mx, [mn[0], mx[1]]], np.float64)
        return corners, (mn + mx) / 2
    return best[1], best[2]


def fill_convex_quad_reference(corners: np.ndarray, shape, value: int = 255) -> np.ndarray:
    """The scanline fill in numpy, rounding each span's ends half away from
    zero as the library's std::lround does."""
    h, w = shape
    c = np.ascontiguousarray(np.rint(corners), np.int32)
    img = np.zeros((h, w), np.uint8)
    px, py = c[:, 0].astype(float), c[:, 1].astype(float)
    y0, y1 = max(int(np.floor(py.min())), 0), min(int(np.ceil(py.max())), h - 1)
    for y in range(y0, y1 + 1):
        xs = []
        for i in range(4):
            j = (i + 1) % 4
            ay, by = py[i], py[j]
            if y < min(ay, by) or y > max(ay, by):
                continue
            if abs(by - ay) < 1e-12:
                xs += [px[i], px[j]]
            else:
                xs.append(px[i] + (px[j] - px[i]) * (y - ay) / (by - ay))
        if not xs:
            continue
        xa = max(_lround(min(xs)), 0)
        xb = min(_lround(max(xs)), w - 1)
        if xb >= xa:
            img[y, xa:xb + 1] = value
    return img


def _lround(v: float) -> int:
    """std::lround: round half away from zero."""
    return int(np.floor(v + 0.5)) if v >= 0 else int(np.ceil(v - 0.5))
