"""Synthetic raw spine CTs: the input of the straightening CLIs.

A CT in Hounsfield units and its vertebra mask as a scanner and a
segmentation model give them, before straightening: vertebral bodies
(elliptic cylinders) with two pedicles and a lamina each, stacked along
axis 2 on a curve bent in the plane of axes 0 and 2, and symmetric about
the middle of axis 1, the sagittal normal of `straighten.curve.
sagittal_basis`. No package the port mirrors has such a fixture: the JAX
package's tests and the smoke run on the NIfTI files `write_raw_patient`
writes.
"""

from __future__ import annotations

import os

import numpy as np

from ..utils import nifti

# Hounsfield units: air, soft tissue, cancellous bone; scanner noise
HU_AIR, HU_TISSUE, HU_BONE, HU_NOISE = -1000.0, 40.0, 250.0, 20.0
# the patient's body, an elliptic cylinder, in fractions of the volume
BODY_RADII = (0.45, 0.40)


def make_raw_spine(rng: np.random.Generator, shape=(512, 512, 400), vert_ids=range(13, 25),
                   radii=(22, 18), bend=40.0, margin=20, last_height=None):
    """(ct float32, whole HU; labels uint8) of one spine. The vertebrae fill axis 2
    between `margin` slices at each end, each over 3/4 of its pitch; the
    curve's axis-0 offset is `bend` * sin of the arc. `last_height` cuts the
    last vertebra to that many slices, as a field of view cuts it."""
    nx, ny, nz = shape
    vert_ids = list(vert_ids)
    pitch = (nz - 2 * margin) / len(vert_ids)
    height = int(round(0.75 * pitch))
    rx, ry = radii
    cy = (ny - 1) / 2  # integer rows pair up about it: the mask is symmetric
    x = np.arange(nx, dtype=np.float64)[:, None]
    dy = np.abs(np.arange(ny, dtype=np.float64)[None, :] - cy)
    labels = np.zeros(shape, np.uint8)
    for k, v in enumerate(vert_ids):
        z0 = int(margin + k * pitch)
        z1 = z0 + (last_height if last_height and k == len(vert_ids) - 1 else height)
        xc = nx / 2 + bend * np.sin(np.pi * ((z0 + z1) / 2 - margin) / (nz - 2 * margin))
        body = ((x - xc) / rx) ** 2 + (dy / ry) ** 2 <= 1
        # pedicles leave the body towards -x off the midline; the lamina joins
        # them behind it, so the midline column is empty between the two
        back = xc - rx
        pedicles = (x > back - 18) & (x <= back + 2) & (dy >= ry / 2) & (dy < ry / 2 + 4)
        lamina = (x > back - 24) & (x <= back - 18) & (dy < ry / 2 + 4)
        labels[:, :, z0:z1][body] = v
        mid = slice(z0 + (z1 - z0) // 4, z1 - (z1 - z0) // 4)
        labels[:, :, mid][(pedicles | lamina) & ~body] = v
    bx = (np.arange(nx, dtype=np.float32)[:, None] - (nx - 1) / 2) / (BODY_RADII[0] * nx)
    by = (np.arange(ny, dtype=np.float32)[None, :] - cy) / (BODY_RADII[1] * ny)
    plane = np.where(bx ** 2 + by ** 2 <= 1, HU_TISSUE, HU_AIR).astype(np.float32)
    ct = rng.standard_normal(shape, dtype=np.float32)
    ct *= HU_NOISE
    ct += plane[:, :, None]
    ct[labels > 0] += HU_BONE - HU_TISSUE
    np.rint(ct, out=ct)  # a scanner stores whole Hounsfield units
    return ct, labels


def raw_affine(shape, spacing=(0.8, 0.8, 1.0), flip_axis1=False) -> np.ndarray:
    """A scanner affine in RAI axis order (R, A, I: axis 2 runs towards the
    feet); with flip_axis1, the affine of the same scan stored R, P, I
    (the array flipped along axis 1), which maps each voxel to the same
    world point."""
    aff = np.diag([spacing[0], spacing[1], -spacing[2], 1.0])
    aff[:3, 3] = (-100.0, -120.0, 300.0)
    if flip_axis1:
        aff[1, 1] = -spacing[1]
        aff[1, 3] += spacing[1] * (shape[1] - 1)
    return aff


def write_raw_patient(root, patient, ct, labels, affine, mask_suffix="msk"):
    """{root}/{patient}/{patient}.nii.gz (the CT, float32) and
    {patient}_{mask_suffix}.nii.gz (the labels, uint8), as the straightening
    CLIs read them. Returns the patient's directory."""
    pdir = os.path.join(root, patient)
    os.makedirs(pdir, exist_ok=True)
    nifti.save(nifti.Nifti1Image(np.asarray(ct, np.float32), affine),
               os.path.join(pdir, f"{patient}.nii.gz"))
    nifti.save(nifti.Nifti1Image(np.asarray(labels, np.uint8), affine),
               os.path.join(pdir, f"{patient}_{mask_suffix}.nii.gz"))
    return pdir
