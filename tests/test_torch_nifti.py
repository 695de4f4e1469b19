"""Port vs JAX package: the pure-numpy NIfTI-1 reader and writer.

Each package reads what the other writes, equal in data, dtype, affine and
spacing: every dtype the writer knows, .nii and .nii.gz, a scl_slope /
scl_inter header, and the quaternion (qform) affine of a header with no
sform. `reorient_to` and `orientation_codes` agree on oblique and flipped
affines. All comparisons are exact.
"""

import struct

import numpy as np
import pytest

from healthivert_tpu.utils import nifti as jnifti
from healthivert_tpu_torch.utils import nifti

DTYPES = [np.uint8, np.int16, np.int32, np.float32, np.float64, np.int8, np.uint16,
          np.int64]


def _affine(rng):
    a = np.eye(4)
    a[:3, :3] = np.diag(rng.uniform(0.5, 2.0, 3)) @ np.linalg.qr(rng.normal(size=(3, 3)))[0]
    a[:3, 3] = rng.normal(0, 50, 3)
    return a


def _assert_same(a, b):
    assert a.data.dtype == b.data.dtype
    np.testing.assert_array_equal(a.data, b.data)
    np.testing.assert_array_equal(a.affine, b.affine)
    assert a.spacing == b.spacing


@pytest.mark.parametrize("suffix", [".nii", ".nii.gz"])
@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
def test_each_reads_the_others_files(tmp_path, dtype, suffix):
    rng = np.random.default_rng(0)
    data = (rng.normal(0, 100, (7, 5, 3)) if np.dtype(dtype).kind == "f"
            else rng.integers(0, 100, (7, 5, 3))).astype(dtype)
    aff = _affine(rng)
    pa, pb = tmp_path / f"port{suffix}", tmp_path / f"jax{suffix}"
    nifti.save(nifti.Nifti1Image(data, aff), pa)
    jnifti.save(jnifti.Nifti1Image(data, aff), pb)
    for path in (pa, pb):
        _assert_same(nifti.load(path), jnifti.load(path))
    _assert_same(nifti.load(pa), jnifti.load(pb))
    want = data.astype(np.float32) if data.dtype == np.float64 else data
    np.testing.assert_array_equal(nifti.load(pa).data, want)


def _patch(path, **fields):
    """Rewrite header fields of an uncompressed .nii in place."""
    raw = bytearray(path.read_bytes())
    offsets = {"pixdim": (76, "<8f"), "scl": (112, "<2f"), "qform_code": (252, "<h"),
               "sform_code": (254, "<h"), "quatern": (256, "<3f"), "qoffset": (268, "<3f")}
    for k, v in fields.items():
        off, fmt = offsets[k]
        struct.pack_into(fmt, raw, off, *(v if isinstance(v, tuple) else (v,)))
    path.write_bytes(bytes(raw))


@pytest.mark.parametrize("scl", [(2.5, -7.0), (float("nan"), float("nan")), (0.0, 3.0)],
                         ids=["slope", "nan", "zero-slope"])
def test_scl_slope_and_qform_fallback(tmp_path, scl):
    data = np.arange(60, dtype=np.int16).reshape(5, 4, 3)
    path = tmp_path / "v.nii"
    nifti.save(nifti.Nifti1Image(data, np.eye(4)), path)
    _patch(path, scl=scl, sform_code=0, qform_code=1, quatern=(0.1, -0.2, 0.3),
           qoffset=(4.0, -5.0, 6.0), pixdim=(-1.0, 0.8, 1.2, 2.5, 0, 0, 0, 0))
    got, want = nifti.load(path), jnifti.load(path)
    _assert_same(got, want)
    assert not np.allclose(got.affine[:3, :3], np.eye(3))


def test_reorient_to_matches(tmp_path):
    rng = np.random.default_rng(3)
    data = rng.integers(0, 255, (6, 5, 4)).astype(np.uint8)
    for _ in range(6):
        perm = rng.permutation(3)
        aff = np.eye(4)
        aff[:3, :3] = (np.eye(3)[:, perm] * rng.choice([-1, 1], 3) * rng.uniform(0.5, 2, 3)
                       + rng.normal(0, 0.1, (3, 3)))
        aff[:3, 3] = rng.normal(0, 10, 3)
        assert nifti.orientation_codes(aff) == jnifti.orientation_codes(aff)
        for codes in (("R", "A", "I"), ("L", "P", "S"), ("A", "S", "R")):
            got = nifti.reorient_to(nifti.Nifti1Image(data, aff, (1.0, 2.0, 3.0)), codes)
            want = jnifti.reorient_to(jnifti.Nifti1Image(data, aff, (1.0, 2.0, 3.0)), codes)
            _assert_same(got, want)
