"""Minimal pure-numpy NIfTI-1 reader/writer.

A copy of healthivert_tpu/utils/nifti.py:1-277 (the port imports nothing
from the JAX package): single-file .nii / .nii.gz, scalar dtypes, affine via
srow, quaternion qform fallback when sform_code == 0, and optional
scl_slope/scl_inter (non-finite values mean "no scaling", as in nibabel).
One difference: `save` gzips at level 1 (nibabel's default) instead of 9.
The decoded volume is the same; level 9 takes tens of seconds on a
256 x 256 x 64 float32 CT volume, level 1 well under one.

Data is returned in Fortran (column-major) axis order like nibabel's
get_fdata(): array[i, j, k] with i fastest-varying on disk.
"""

from __future__ import annotations

import gzip
import os
import struct
from dataclasses import dataclass, field

import numpy as np

_HDR_SIZE = 348
GZIP_LEVEL = 1
_MAGIC_N1 = b"n+1\x00"

# NIfTI datatype codes -> numpy dtypes
_DTYPES = {
    2: np.uint8,
    4: np.int16,
    8: np.int32,
    16: np.float32,
    64: np.float64,
    256: np.int8,
    512: np.uint16,
    768: np.uint32,
    1024: np.int64,
    1280: np.uint64,
}
_DTYPE_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}


@dataclass
class Nifti1Image:
    """A loaded NIfTI volume: raw data + affine + voxel spacing."""

    data: np.ndarray
    affine: np.ndarray = field(default_factory=lambda: np.eye(4))
    spacing: tuple = (1.0, 1.0, 1.0)

    def get_fdata(self) -> np.ndarray:
        return np.asarray(self.data, dtype=np.float64)

    @property
    def shape(self):
        return self.data.shape


def _open(path, mode="rb"):
    if str(path).endswith(".gz"):
        return gzip.open(path, mode)
    return open(path, mode)


def _qform_affine(quatern, qoffset, pixdim) -> np.ndarray:
    """NIfTI-1 'method 2' affine from the qform quaternion (used when
    sform_code == 0 and qform_code > 0 — common for scanner-written files;
    nibabel falls back to it the same way). Per the spec: a is recovered
    from b/c/d, the rotation's third column is scaled by qfac = pixdim[0]
    (-1 flips the k axis; any other value means +1)."""
    b, c, d = (float(q) for q in quatern)
    a2 = 1.0 - (b * b + c * c + d * d)
    a = np.sqrt(a2) if a2 > 0.0 else 0.0  # rounding can push a2 slightly < 0
    r = np.array(
        [
            [a * a + b * b - c * c - d * d, 2 * (b * c - a * d), 2 * (b * d + a * c)],
            [2 * (b * c + a * d), a * a + c * c - b * b - d * d, 2 * (c * d - a * b)],
            [2 * (b * d - a * c), 2 * (c * d + a * b), a * a + d * d - b * b - c * c],
        ],
        dtype=np.float64,
    )
    qfac = -1.0 if pixdim[0] == -1.0 else 1.0
    zooms = np.array(
        [abs(pixdim[1]) or 1.0, abs(pixdim[2]) or 1.0, (abs(pixdim[3]) or 1.0) * qfac]
    )
    affine = np.eye(4)
    affine[:3, :3] = r * zooms  # column-wise scaling
    affine[:3, 3] = qoffset
    return affine


def load(path) -> Nifti1Image:
    """Load a .nii or .nii.gz file."""
    with _open(path, "rb") as f:
        raw = f.read()
    hdr = raw[:_HDR_SIZE]
    (sizeof_hdr,) = struct.unpack("<i", hdr[0:4])
    endian = "<"
    if sizeof_hdr != _HDR_SIZE:
        endian = ">"
        (sizeof_hdr,) = struct.unpack(">i", hdr[0:4])
        if sizeof_hdr != _HDR_SIZE:
            raise ValueError(f"not a NIfTI-1 file: {path}")

    dim = struct.unpack(endian + "8h", hdr[40:56])
    ndim = dim[0]
    shape = tuple(int(d) for d in dim[1 : 1 + ndim])
    (datatype,) = struct.unpack(endian + "h", hdr[70:72])
    pixdim = struct.unpack(endian + "8f", hdr[76:108])
    (vox_offset,) = struct.unpack(endian + "f", hdr[108:112])
    scl_slope, scl_inter = struct.unpack(endian + "2f", hdr[112:120])
    srow_x = struct.unpack(endian + "4f", hdr[280:296])
    srow_y = struct.unpack(endian + "4f", hdr[296:312])
    srow_z = struct.unpack(endian + "4f", hdr[312:328])
    (qform_code,) = struct.unpack(endian + "h", hdr[252:254])
    (sform_code,) = struct.unpack(endian + "h", hdr[254:256])
    quatern = struct.unpack(endian + "3f", hdr[256:268])
    qoffset = struct.unpack(endian + "3f", hdr[268:280])

    if datatype not in _DTYPES:
        raise ValueError(f"unsupported NIfTI datatype code {datatype}")
    dtype = np.dtype(_DTYPES[datatype]).newbyteorder(endian)

    count = int(np.prod(shape)) if shape else 0
    start = int(vox_offset)
    data = np.frombuffer(raw, dtype=dtype, count=count, offset=start)
    data = data.reshape(shape, order="F")
    # Always copy: frombuffer yields a read-only view when the dtype is
    # already native-endian, and callers mutate loaded volumes in place.
    data = np.array(data, dtype=data.dtype.newbyteorder("="), order="F")

    # nibabel semantics: a slope of 0, NaN, or inf means "no scaling" (many
    # writers leave scl_slope/scl_inter as NaN); a non-finite inter is 0.
    # Applying NaN arithmetic here would silently turn the whole volume NaN.
    slope = scl_slope if np.isfinite(scl_slope) and scl_slope != 0.0 else 1.0
    inter = scl_inter if np.isfinite(scl_inter) else 0.0
    if (slope, inter) != (1.0, 0.0):
        data = data * slope + inter

    if sform_code > 0:
        affine = np.array([srow_x, srow_y, srow_z, [0, 0, 0, 1]], dtype=np.float64)
    elif qform_code > 0:
        affine = _qform_affine(quatern, qoffset, pixdim)
    else:
        affine = np.diag([pixdim[1] or 1.0, pixdim[2] or 1.0, pixdim[3] or 1.0, 1.0])
    spacing = tuple(float(abs(p)) or 1.0 for p in pixdim[1:4])
    return Nifti1Image(data=data, affine=affine, spacing=spacing)


def save(img: Nifti1Image, path) -> None:
    """Write a .nii or .nii.gz file (NIfTI-1 single-file)."""
    data = np.asarray(img.data)
    if data.dtype == np.float64:
        data = data.astype(np.float32)
    if data.dtype not in _DTYPE_CODES:
        data = data.astype(np.float32)
    code = _DTYPE_CODES[np.dtype(data.dtype)]
    shape = data.shape
    ndim = len(shape)
    dim = [ndim] + list(shape) + [1] * (7 - ndim)

    affine = np.asarray(img.affine, dtype=np.float64)
    # voxel sizes from affine columns
    pixdim = [1.0] + [float(np.linalg.norm(affine[:3, i])) or 1.0 for i in range(3)] + [0.0] * 4

    hdr = bytearray(_HDR_SIZE)
    struct.pack_into("<i", hdr, 0, _HDR_SIZE)
    struct.pack_into("<8h", hdr, 40, *dim)
    struct.pack_into("<h", hdr, 70, code)
    struct.pack_into("<h", hdr, 72, data.dtype.itemsize * 8)  # bitpix
    struct.pack_into("<8f", hdr, 76, *pixdim)
    struct.pack_into("<f", hdr, 108, 352.0)  # vox_offset
    struct.pack_into("<2f", hdr, 112, 1.0, 0.0)  # scl_slope/inter
    # qform_code 0: we only write an sform; a code of 1 with zeroed
    # quaternion fields would advertise a bogus identity qform to readers
    struct.pack_into("<h", hdr, 252, 0)
    struct.pack_into("<h", hdr, 254, 1)  # sform_code
    struct.pack_into("<4f", hdr, 280, *affine[0])
    struct.pack_into("<4f", hdr, 296, *affine[1])
    struct.pack_into("<4f", hdr, 312, *affine[2])
    hdr[344:348] = _MAGIC_N1

    payload = bytes(hdr) + b"\x00" * 4 + data.tobytes(order="F")
    if str(path).endswith(".gz"):
        payload = gzip.compress(payload, compresslevel=GZIP_LEVEL)
    tmp = str(path) + ".tmp"
    with open(tmp, "wb") as f:
        f.write(payload)
    os.replace(tmp, path)

# ------------------------------------------------------- axis orientation
#
# The reference's reorient_to (straighten_mask_3d.py:45-57) leans on
# nibabel.orientations to bring real-world scans into a canonical axis order
# before straightening. Same semantics here, pure numpy: every data axis is
# matched to its nearest world axis (+/- direction), then flips + transpose
# carry the array to the requested axis codes and the affine is updated so
# world coordinates are preserved.

_AXIS_CODES = (("L", "R"), ("P", "A"), ("I", "S"))  # (negative, positive) per world axis


def _orientation_of(affine: np.ndarray) -> np.ndarray:
    """(3, 2) rows indexed by data axis: [world_axis, direction]. Greedy
    largest-|cosine| assignment of data axes to world axes."""
    rzs = np.asarray(affine, np.float64)[:3, :3]
    zooms = np.linalg.norm(rzs, axis=0)
    zooms[zooms == 0] = 1.0
    cos = rzs / zooms
    out = np.zeros((3, 2), np.int64)
    score = np.abs(cos.copy())
    for _ in range(3):
        w, d = divmod(int(np.argmax(score)), 3)  # world axis w, data axis d
        out[d] = (w, 1 if cos[w, d] >= 0 else -1)
        score[w, :] = -1.0
        score[:, d] = -1.0
    return out


def _axcodes_orientation(axcodes) -> np.ndarray:
    """Orientation rows for axis-code labels, e.g. ('R','A','I')."""
    out = []
    for code in axcodes:
        for world_axis, (neg, pos) in enumerate(_AXIS_CODES):
            if code == pos:
                out.append((world_axis, 1))
                break
            if code == neg:
                out.append((world_axis, -1))
                break
        else:
            raise ValueError(f"unknown axis code {code!r}")
    return np.asarray(out, np.int64)


def orientation_codes(affine: np.ndarray) -> tuple:
    """Axis-code labels of a volume's current orientation, e.g. ('R','A','S')."""
    return tuple(
        _AXIS_CODES[w][(d + 1) // 2] for w, d in _orientation_of(affine)
    )


def reorient_to(img: Nifti1Image, axcodes_to=("R", "A", "I")) -> Nifti1Image:
    """Return a copy of img with data axes rearranged to the requested axis
    codes and an affine mapping the new indices to the SAME world points
    (reference reorient_to, straighten_mask_3d.py:45-57)."""
    cur = _orientation_of(img.affine)
    want = _axcodes_orientation(axcodes_to)

    # per data axis: where it must land and whether it flips
    dest = np.zeros(3, np.int64)
    flip = np.zeros(3, np.int64)
    for d in range(3):
        w, s = cur[d]
        k = int(np.where(want[:, 0] == w)[0][0])
        dest[d] = k
        flip[d] = s * want[k, 1]

    arr = np.asarray(img.data)
    for d in range(3):
        if flip[d] < 0:
            arr = np.flip(arr, axis=d)
    perm = np.argsort(dest)  # new axis k comes from old axis perm[k]
    arr = np.transpose(arr, tuple(perm) + tuple(range(3, arr.ndim)))

    # index map new -> old: old_index = P @ new_index (+ flip offsets), so
    # new_affine = old_affine @ T with T built in old-axis order.
    t = np.eye(4)
    for d in range(3):
        t[d, :] = 0.0
        t[d, dest[d]] = float(flip[d])
        if flip[d] < 0:
            t[d, 3] = float(img.data.shape[d] - 1)
    new_affine = np.asarray(img.affine, np.float64) @ t
    spacing = tuple(float(img.spacing[perm[k]]) for k in range(3))
    return Nifti1Image(data=np.ascontiguousarray(arr), affine=new_affine, spacing=spacing)
