"""Curve-following resampling: the core of the spine straightening.

Counterpart of healthivert_tpu/straighten/curve.py. The curve math (a
handful of knots: arc-length resampling, local bases, the sampling grid and
the global <-> local point mapping) is the JAX package's numpy, copied as it
is, so it gives the same float64 values bit for bit. The volume resample,
millions of gathers, runs in PyTorch on the volume's device
(`map_coordinates_3d`): the JAX package's `jax.scipy.ndimage.
map_coordinates` (order 0 or 1, mode "constant") written out from its
indices and weights, in float32.
"""

from __future__ import annotations

import itertools
import warnings
from typing import Callable, Sequence, Union

import numpy as np
import torch

from ..utils.device import resolve_device

ShapeLike = Union[int, Sequence[int]]


def frenet_serret(*gradients):
    """Gram-Schmidt orthonormalization of successive derivatives -> basis
    stack of shape (n, dim, dim) (columns are basis vectors)."""
    basis = []
    for grad in gradients:
        e = grad
        for v in basis:
            e = e - v * (v * grad).sum(axis=-1, keepdims=True)
        e = e / np.linalg.norm(e, axis=-1, keepdims=True)
        basis.append(e)
    return np.stack(basis, -1)


def sagittal_basis(grad, *args):
    """Local basis whose second vector lies in the sagittal (x-z) plane,
    oriented to avoid axial rotations (straighten_mask_3d.py:155-170).
    Axis convention: points are (X, Y, Z) with Y the sagittal normal."""
    grad = grad / np.linalg.norm(grad, axis=1, keepdims=True)
    sagittal = grad[:, [0, 2]]
    second = sagittal[:, ::-1] * [1, -1]
    dets = np.linalg.det(np.stack([sagittal, second], -1))
    second = second * dets[:, None]
    second = second / np.linalg.norm(second, axis=1, keepdims=True)
    second = np.insert(second, 1, np.zeros_like(second[:, 0]), axis=1)
    third = np.cross(second, grad)
    return np.stack([grad, second, third], -1)


def cumulative_length(curve: np.ndarray) -> np.ndarray:
    lengths = np.cumsum(np.linalg.norm(np.diff(curve, axis=0), axis=1))
    return np.insert(lengths, 0, 0)


def _interp1d(x, y, xs):
    """Linear interp of y (n, d) sampled at x (n,) onto xs, extrapolating."""
    y = np.asarray(y, np.float64)
    out = np.empty((len(xs),) + y.shape[1:], np.float64)
    for j in range(y.shape[1] if y.ndim > 1 else 1):
        col = y[:, j] if y.ndim > 1 else y
        out_col = np.interp(xs, x, col)
        # np.interp clamps; extrapolate linearly at both ends
        lo = xs < x[0]
        hi = xs > x[-1]
        if lo.any():
            s = (col[1] - col[0]) / (x[1] - x[0] + 1e-12)
            out_col = np.where(lo, col[0] + (xs - x[0]) * s, out_col)
        if hi.any():
            s = (col[-1] - col[-2]) / (x[-1] - x[-2] + 1e-12)
            out_col = np.where(hi, col[-1] + (xs - x[-1]) * s, out_col)
        if y.ndim > 1:
            out[:, j] = out_col
        else:
            out = out_col
    return out


def get_derivatives(curve: np.ndarray, step: float):
    """Arc-length resample of the curve and its first `dim` derivatives
    (curve.py:209-220)."""
    _, d = curve.shape
    lengths = cumulative_length(curve)
    xs = np.arange(0, lengths[-1], step)
    yield _interp1d(lengths, curve, xs)
    grad = curve
    for _ in range(d):
        grad = np.gradient(grad, axis=0)
        yield _interp1d(lengths, grad, xs)


def pixel_to_spatial(points, spacing):
    points = np.asarray(points, np.float64)
    if not points.size:
        return points
    return points * np.asarray(spacing, np.float64)


def spatial_to_pixel(points, spacing):
    points = np.asarray(points, np.float64)
    if not points.size:
        return points
    return points / np.asarray(spacing, np.float64)


# points of a resample gathered at once: bounds the index and weight
# tensors to a few hundred MB whatever the grid (a 512 x 512 x 400 CT
# straightened onto 128 x 128 planes has ~7.4 M points)
CHUNK_POINTS = 1 << 22


def _round_half_away_from_zero(c: torch.Tensor) -> torch.Tensor:
    """lax.round: ties away from zero. c - trunc(c) is exact, so no tie is
    moved as floor(c + 0.5) moves 0.49999997 (its sum rounds to 1.0)."""
    t = torch.trunc(c)
    return t + torch.where((c - t).abs() >= 0.5, torch.sign(c), torch.zeros_like(c))


def _corners(c: torch.Tensor, order: int):
    """[(index, weight)] of one axis, as jax.scipy.ndimage's
    _nearest_indices_and_weights / _linear_indices_and_weights."""
    if order == 0:
        return [(_round_half_away_from_zero(c).to(torch.int64), None)]
    lower = torch.floor(c)
    upper_weight = c - lower
    index = lower.to(torch.int64)
    return [(index, 1 - upper_weight), (index + 1, upper_weight)]


def map_coordinates_3d(volume: torch.Tensor, coords: torch.Tensor, order: int = 1,
                       cval: float = 0.0) -> torch.Tensor:
    """`volume` (X, Y, Z) float32 sampled at `coords` (3, ...) float32 on
    its device: jax.scipy.ndimage.map_coordinates(order 0 | 1, mode
    "constant") in the same float32 arithmetic. Order 0 takes the voxel at
    the coordinates rounded half away from zero; order 1 sums the 8 corners
    (w_x * w_y) * w_z * value in itertools.product order. A corner with an
    index outside [0, size) on any axis contributes `cval`; indices are
    clamped before the gather, so no read leaves the volume."""
    if order not in (0, 1):
        raise NotImplementedError(f"map_coordinates_3d: order {order} (0 or 1)")
    if volume.dim() != 3 or coords.shape[0] != 3:
        raise ValueError(f"map_coordinates_3d: volume (X, Y, Z) and coords (3, ...) expected, "
                         f"got {tuple(volume.shape)} and {tuple(coords.shape)}")
    if volume.dtype != torch.float32 or coords.dtype != torch.float32:
        raise TypeError("map_coordinates_3d: volume and coords must be float32")
    sizes = volume.shape
    flat_vol = volume.reshape(-1)
    flat = coords.reshape(3, -1)
    out = torch.empty(flat.shape[1], dtype=torch.float32, device=volume.device)
    cval_t = torch.tensor(cval, dtype=torch.float32, device=volume.device)
    for start in range(0, flat.shape[1], CHUNK_POINTS):
        c = flat[:, start:start + CHUNK_POINTS]
        axes = []
        for a in range(3):
            axes.append([(torch.clamp(i, 0, sizes[a] - 1), (i >= 0) & (i < sizes[a]), w)
                         for i, w in _corners(c[a], order)])
        acc = None
        for (ix, vx, wx), (iy, vy, wy), (iz, vz, wz) in itertools.product(*axes):
            value = flat_vol[(ix * sizes[1] + iy) * sizes[2] + iz]
            term = torch.where(vx & vy & vz, value, cval_t)
            if order == 1:
                term = ((wx * wy) * wz) * term
            acc = term if acc is None else acc + term
        out[start:start + c.shape[1]] = acc
    return out.reshape(coords.shape[1:])


class Interpolator:
    """Arc-length curve interpolator (curve.py:26-157)."""

    def __init__(
        self,
        curve: np.ndarray,
        step: float,
        spacing: Union[float, Sequence[float]] = 1,
        get_local_basis: Callable = frenet_serret,
    ):
        if curve.ndim != 2:
            raise ValueError(
                f"The curve shape must be (n_points, dim), but {curve.shape} provided."
            )
        dim = curve.shape[1]
        if isinstance(spacing, (int, float)):
            spacing = [spacing] * dim
        if dim != len(spacing):
            raise ValueError(f'"spacing" must contain {dim} elements.')
        if not np.isfinite(curve).all():
            raise ValueError("The curve must contain only finite values.")

        even_curve, *grads = get_derivatives(pixel_to_spatial(curve, spacing), step)
        self.dim = dim
        self.spacing = list(spacing)
        self.knots = even_curve
        self.basis = get_local_basis(*grads)

    def get_grid(self, shape: ShapeLike) -> np.ndarray:
        """Sampling grid of shape (dim, n_points, *shape) (curve.py:54-75)."""
        shape = np.broadcast_to(shape, self.dim - 1)
        grid = np.meshgrid(*(np.arange(s) - s / 2 for s in shape))
        zs = np.zeros_like(grid[0])
        grid = np.stack([zs, *grid])
        grid = np.einsum("Nij,j...->Ni...", self.basis, grid)
        grid = np.moveaxis(grid, [0, 1], [-2, -1])
        grid = spatial_to_pixel(grid + self.knots, self.spacing)
        return np.moveaxis(grid, [-2, -1], [1, 0])

    def interpolate_along(self, array, shape: ShapeLike, fill_value=0, order: int = 1,
                          device="cuda") -> np.ndarray:
        """Resample `array` along the curve onto (n_points, *shape) planes,
        on `device` (the card unless the caller passes "cpu"; raises
        without one). The volume and the float64 grid are cast to float32
        on the host, as the JAX package casts them; the result comes back
        as a numpy float32 array."""
        dev = resolve_device(device)
        if callable(fill_value):
            fill_value = fill_value(array)
        grid = self.get_grid(shape)
        # cast in the volume's own memory order (a NIfTI volume is Fortran
        # order); the device makes it C order
        host = np.asarray(array, np.float32)
        if not (host.flags.c_contiguous or host.flags.f_contiguous):
            host = np.ascontiguousarray(host)
        volume = torch.from_numpy(host).to(dev).contiguous()
        coords = torch.from_numpy(np.ascontiguousarray(grid, np.float32)).to(dev)
        out = map_coordinates_3d(volume, coords, order=order, cval=float(fill_value))
        return out.cpu().numpy()

    # ---- point mapping (host-side, tiny: a handful of centroids) ----
    #
    # Model: every knot k carries an orthonormal frame basis[k] and a
    # "plane coordinate" s = the component of (point - anchor_k) along the
    # curve tangent. A point belongs to the knot plane where s crosses zero;
    # its mapped coordinates are the candidate rows (one per knot) linearly
    # resolved at that crossing. Both directions share the same resolver;
    # they differ only in which side of the frame rotation they start on.

    def _plane_centers(self, shape):
        """Local-space anchor of each knot plane: (arc length, shape/2...)."""
        centers = np.zeros_like(self.knots)
        centers[:, 0] = cumulative_length(self.knots)
        centers[:, 1:] = shape / 2
        return centers

    def _candidates_to_local(self, points, shape):
        """All points vs all knots at once. Returns (rows, s, r):
        rows (m, n, dim) candidate local coordinates, s (m, n) signed
        distance to each knot plane, r (m, n) distance to each knot."""
        diffs = points[:, None, :] - self.knots[None]  # (m, n, dim)
        r = np.linalg.norm(diffs, axis=-1)
        local = np.einsum("nji,mnj->mni", self.basis, diffs)
        return local + self._plane_centers(shape)[None], local[..., 0], r

    def _candidates_to_global(self, points, shape):
        rel = points[:, None, :] - self._plane_centers(shape)[None]  # (m, n, dim)
        rows = np.einsum("nij,mnj->mni", self.basis, rel)
        # frames are orthonormal, so the rotation preserves distances
        return rows + self.knots[None], rel[..., 0], np.linalg.norm(rel, axis=-1)

    def _check_points(self, points):
        points = np.asarray(points)
        if points.shape[-1] != self.dim:
            raise ValueError(
                f"The points dim ({points.shape[-1]}) doesn't match the curve dim ({self.dim})."
            )
        return points

    def _map_points(self, points, shape, candidates_fn):
        points = np.asarray(points, np.float64)
        *lead, d = points.shape
        shape = np.broadcast_to(shape, d - 1)
        rows, s, r = candidates_fn(points.reshape(-1, d), shape)
        out = np.stack(
            [_resolve_plane_crossing(rows[i], s[i], r[i]) for i in range(rows.shape[0])]
        )
        return out.reshape(*lead, d)

    def global_to_local(self, points, shape: ShapeLike):
        points = pixel_to_spatial(self._check_points(points), self.spacing)
        return self._map_points(points, shape, self._candidates_to_local)

    def local_to_global(self, points, shape: ShapeLike):
        out = self._map_points(self._check_points(points), shape, self._candidates_to_global)
        return spatial_to_pixel(out, self.spacing)


def _resolve_plane_crossing(rows, s, r):
    """Pick the knot plane containing the point (the s sign change nearest
    the closest knot) and evaluate the candidate rows at s = 0 within a
    4-knot window: interpolate between the bracketing pair, or extrapolate
    from the two extreme rows when 0 falls outside the window's s range."""
    idx = int(r.argmin())
    (crossings,) = np.nonzero(np.diff(np.sign(s)))
    if len(crossings) != 1:
        warnings.warn("Couldn't uniquely choose a local basis.")
    if len(crossings) > 0:
        idx = int(crossings[np.abs(crossings - idx).argmin()])
    window = slice(max(0, idx - 2), idx + 2)
    sw, rw = s[window], rows[window]

    order = np.argsort(sw)
    sw, rw = sw[order], rw[order]
    eps = 0.0
    if 0 <= sw[0]:  # every plane in the window is ahead: extrapolate back
        lo, hi, eps = 0, 1, 1e-12
    elif 0 >= sw[-1]:  # every plane behind: extrapolate forward
        lo, hi, eps = len(sw) - 2, len(sw) - 1, 1e-12
    else:  # bracketing pair around s = 0
        hi = int(np.searchsorted(sw, 0.0, side="left"))
        if sw[hi] == 0.0:  # exact hit: return that plane's row
            return rw[hi]
        lo = hi - 1
    t = (0.0 - sw[lo]) / (sw[hi] - sw[lo] + eps)
    return rw[lo] + t * (rw[hi] - rw[lo])
