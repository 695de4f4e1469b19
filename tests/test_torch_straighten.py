"""The port's straightening (healthivert_tpu_torch/straighten/) against the
JAX package's (healthivert_tpu/straighten/) on the CPU:

- the curve math, numpy in both, bit for bit: bases, knots, grids and the
  global <-> local point mapping;
- the resample: `map_coordinates_3d` against jax.scipy.ndimage.
  map_coordinates, order 0 bit for bit (ties at +-0.5, 1.5, 2.5 and
  0.49999997, points outside the volume), order 1 within 1e-5 of the
  largest value (XLA fuses the corner products and sums in another order);
- every pipeline and axial function on the cases of tests/test_straighten.py
  and on the raw cohort of tests/straighten_cohort.py.
"""

import functools
import json
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from healthivert_tpu.straighten import axial as jax_axial
from healthivert_tpu.straighten import curve as jax_curve
from healthivert_tpu.straighten import pipeline as jax_pipeline
from healthivert_tpu_torch.data.synthetic import make_spine_volume
from healthivert_tpu_torch.straighten import axial, curve, pipeline
from healthivert_tpu_torch.utils import nifti
from straighten_cohort import write_raw_cohort

ORDER1_REL = 1e-5


def _curve(seed=0, n=30):
    rng = np.random.default_rng(seed)
    t = np.linspace(0, 1, n)
    return np.stack([40 + 8 * np.sin(3 * t) + rng.normal(0, 0.3, n), 30 + 2 * np.cos(2 * t),
                     10 + 90 * t], -1)


def test_curve_functions_equal_jax_bit_for_bit():
    c = _curve()
    grads = [np.gradient(c, axis=0)]
    grads += [np.gradient(grads[0], axis=0), np.gradient(np.gradient(grads[0], axis=0), axis=0)]
    for name in ("frenet_serret", "sagittal_basis"):
        assert np.array_equal(getattr(curve, name)(*grads), getattr(jax_curve, name)(*grads))
    assert np.array_equal(curve.cumulative_length(c), jax_curve.cumulative_length(c))
    for a, b in zip(curve.get_derivatives(c, 0.7), jax_curve.get_derivatives(c, 0.7)):
        assert np.array_equal(a, b)
    xs = np.linspace(-5, 40, 23)  # extrapolated at both ends
    x = np.sort(np.random.default_rng(1).uniform(0, 30, 9))
    y = np.random.default_rng(2).normal(size=(9, 3))
    assert np.array_equal(curve._interp1d(x, y, xs), jax_curve._interp1d(x, y, xs))
    assert np.array_equal(curve._interp1d(x, y[:, 0], xs), jax_curve._interp1d(x, y[:, 0], xs))
    for fn in ("pixel_to_spatial", "spatial_to_pixel"):
        assert np.array_equal(getattr(curve, fn)(c, (0.8, 0.9, 1.2)),
                              getattr(jax_curve, fn)(c, (0.8, 0.9, 1.2)))
        assert getattr(curve, fn)(np.zeros((0, 3)), 2.0).size == 0


@pytest.mark.parametrize("basis,spacing", [("frenet_serret", 1), ("sagittal_basis", 1),
                                           ("sagittal_basis", (0.8, 0.9, 1.2))])
def test_interpolator_equals_jax_bit_for_bit(basis, spacing):
    c = _curve(3)
    mine = curve.Interpolator(c, step=1, spacing=spacing, get_local_basis=getattr(curve, basis))
    ref = jax_curve.Interpolator(c, step=1, spacing=spacing,
                                 get_local_basis=getattr(jax_curve, basis))
    assert np.array_equal(mine.knots, ref.knots) and np.array_equal(mine.basis, ref.basis)
    for shape in ((16, 12), 9):
        assert np.array_equal(mine.get_grid(shape), ref.get_grid(shape))
    pts = c[4:26:3] + np.random.default_rng(4).normal(0, 1.5, (8, 3))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        local = mine.global_to_local(pts, (64, 64))
        assert np.array_equal(local, ref.global_to_local(pts, (64, 64)))
        assert np.array_equal(mine.local_to_global(local, (64, 64)),
                              ref.local_to_global(local, (64, 64)))
        assert np.array_equal(mine.global_to_local(pts[0], 64), ref.global_to_local(pts[0], 64))
    with pytest.raises(ValueError, match="points dim"):
        mine.global_to_local(pts[:, :2], (64, 64))


def _coords(shape, n=4000, seed=0):
    """Random points around and outside a volume of `shape`, with ties at
    +-0.5, 1.5, 2.5, the float32 below 0.5, and the upper edges."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(-3, max(shape) + 3, (3, n)).astype(np.float32)
    ties = np.array([0.5, -0.5, 1.5, 2.5, -1.5, 0.49999997, -0.49999997, 0.5000001, 3.0, -1.0,
                     -0.0], np.float32)
    c[:, :len(ties)] = ties
    for a, s in enumerate(shape):
        c[a, 20:30] = np.float32(s) - np.float32([0.5, 0.49999997, 1.5, 1.0, 0.0, -0.5, 0.5, 1, 2,
                                                  3])
        c[a, 100:300] = np.floor(c[a, 100:300]) + np.float32(0.5)  # all ties on this axis
    return c


@pytest.mark.parametrize("order", [0, 1])
@pytest.mark.parametrize("cval", [0.0, -7.5])
def test_map_coordinates_equals_jax(order, cval):
    vol = (np.random.default_rng(5).standard_normal((20, 17, 13)) * 100).astype(np.float32)
    coords = _coords(vol.shape).reshape(3, 40, 100)
    want = np.asarray(jax.scipy.ndimage.map_coordinates(
        jnp.asarray(vol), list(jnp.asarray(coords)), order=order, mode="constant", cval=cval))
    got = curve.map_coordinates_3d(torch.from_numpy(vol), torch.from_numpy(coords), order,
                                   cval).numpy()
    assert got.shape == want.shape == (40, 100) and got.dtype == np.float32
    if order == 0:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=ORDER1_REL * np.abs(vol).max())
    assert (got == cval).sum() > 0  # some points fall outside


def test_map_coordinates_chunks_and_rejects(monkeypatch):
    vol = torch.from_numpy(np.random.default_rng(6).random((9, 8, 7)).astype(np.float32))
    coords = torch.from_numpy(_coords((9, 8, 7), 1000))
    whole = [curve.map_coordinates_3d(vol, coords, order) for order in (0, 1)]
    monkeypatch.setattr(curve, "CHUNK_POINTS", 97)
    for order in (0, 1):
        assert torch.equal(curve.map_coordinates_3d(vol, coords, order), whole[order])
    with pytest.raises(NotImplementedError):
        curve.map_coordinates_3d(vol, coords, 3)
    with pytest.raises(TypeError):
        curve.map_coordinates_3d(vol.double(), coords.double(), 1)
    with pytest.raises(ValueError):
        curve.map_coordinates_3d(vol[0], coords, 1)


@pytest.mark.parametrize("order", [0, 1])
def test_interpolate_along_equals_jax(order):
    rng = np.random.default_rng(7)
    vol = rng.random((40, 32, 48)) * (20 if order == 0 else 300)
    if order == 0:
        vol = np.floor(vol)
    vol += 1  # no zero inside: 0 marks the points outside
    c = np.stack([np.full(6, 20.0) + np.arange(6), np.full(6, 16.0), np.linspace(5, 40, 6)], -1)
    mine = curve.Interpolator(c, step=1, get_local_basis=curve.sagittal_basis)
    ref = jax_curve.Interpolator(c, step=1, get_local_basis=jax_curve.sagittal_basis)
    got = mine.interpolate_along(vol, (24, 20), order=order, device="cpu")
    want = ref.interpolate_along(vol, (24, 20), order=order)
    assert got.shape == want.shape and got.dtype == np.float32
    if order == 0:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=ORDER1_REL * np.abs(vol).max())
    got_fill = mine.interpolate_along(vol, (24, 20), fill_value=lambda a: a.min() - 1,
                                      order=order, device="cpu")
    np.testing.assert_array_equal(got_fill == vol.min() - 1, got == 0)


def test_interpolate_along_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    inter = curve.Interpolator(_curve(), step=1)
    with pytest.raises(RuntimeError, match="CUDA device was requested"):
        inter.interpolate_along(np.zeros((8, 8, 8)), (4, 4))


# ------------------------------------------------------------ the pipeline


def test_window_and_extend_curve_equal_jax():
    for img in (np.array([[-500.0, -300.0, 250.0, 800.0, 2000.0]]),
                np.array([[0.0, 100.0]]), np.random.default_rng(0).normal(0, 900, (6, 7, 5))):
        assert np.array_equal(pipeline.window(img.copy(), -300, 800),
                              jax_pipeline.window(img.copy(), -300, 800))
    c = _curve(8, 12)
    for args in ((20, (0, 0, 0), (96, 96, 160)), (500, (0, 0, 0), (50, 60, 70))):
        assert np.array_equal(pipeline.extend_curve(c, *args), jax_pipeline.extend_curve(c, *args))


def test_label_cleanup_and_crops_equal_jax():
    rng = np.random.default_rng(9)
    lab = np.zeros((30, 40, 20))
    lab[5:12, 10:35, 8:12] = 3
    lab[5:12, 28:32, 2:6] = 3  # off the midline column: removed
    lab[15:25, 5:30, 6:14] = 4
    lab[15:25, 33:38, 10] = 4
    assert np.array_equal(pipeline.remove_spine_labels_after_split(lab),
                          jax_pipeline.remove_spine_labels_after_split(lab))
    assert not np.array_equal(pipeline.remove_spine_labels_after_split(lab), lab)
    vol = rng.random((50, 50, 30))
    for center, size in (((25, 25, 15), (16, 16, 8)), ((3.7, 48.2, 1.0), (20, 24, 10)),
                         ((25, 25, 15), (64, 64, 40)), ((10, 10, 5), (8, 8, 30))):
        assert np.array_equal(pipeline.extract_3d_volume(vol, center, size),
                              jax_pipeline.extract_3d_volume(vol, center, size))
    blobs = ((rng.random((40, 40)) > 0.7) * 255).astype(np.uint8)
    for thr in (0, 3, 20):
        assert np.array_equal(pipeline._remove_small_components(blobs, thr),
                              jax_pipeline._remove_small_components(blobs, thr))
    assert pipeline._remove_small_components(np.zeros((5, 5), np.uint8), 20).sum() == 0


@functools.cache
def _mask_cases():
    lab = np.zeros((64, 64, 8))
    lab[20:40, 25:45, 2:6] = 20
    lab[45:60, 25:45, 2:6] = 21
    left = np.zeros((32, 32, 3))
    left[10:16, 2:7, 1] = 5
    left[10:16, 20:27, 1] = 5
    left[12, 4, 1] = 7
    box = np.zeros((40, 40, 10))
    box[10:20, 14:30, 2:7] = 6
    box[0:4, 0:5, 3:5] = 6  # touches the volume's edge
    box[15, 20, 4] = 8
    _, straight, _ = make_spine_volume(np.random.default_rng(0), fractured={20: 0.6})
    return {"two_bodies": (lab, 20), "leftmost": (left, 5), "edge_box": (box, 6),
            "absent": (lab, 9), "straightened_256": (straight.astype(np.float64), 20)}


@pytest.mark.parametrize("case", list(_mask_cases()))
@pytest.mark.parametrize("mode", ["rect", "left", "3d"])
def test_mask_strategies_equal_jax(case, mode):
    lab, label = _mask_cases()[case]
    got = pipeline._MASK_STRATEGIES[mode](lab, label)
    want = jax_pipeline._MASK_STRATEGIES[mode](lab, label)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_centroids_equal_jax(tmp_path):
    seg = np.zeros((60, 40, 40), np.uint8)
    seg[2:4, 2:4, 2:4] = 17  # a small bottom label: dropped
    seg[10:30, 10:30, 10:30] = 18
    seg[35:55, 10:30, 10:31] = 19
    assert pipeline.extract_centroids(seg) == jax_pipeline.extract_centroids(seg)
    assert [c["label"] for c in pipeline.extract_centroids(seg)] == [18, 19]
    rng = np.random.default_rng(11)  # many labels, irregular, in both memory orders
    blobs = (rng.integers(0, 4, (40, 30, 50)) * rng.integers(1, 40, (40, 30, 50))).astype(np.uint8)
    blobs[:20] = np.where(blobs[:20] > 0, 7, 0)  # one label past the 8000 and 6000 bounds
    for vol in (blobs, np.asfortranarray(blobs), np.zeros((4, 5, 6), np.uint8)):
        assert pipeline.extract_centroids(vol) == jax_pipeline.extract_centroids(vol)
    assert np.array_equal(pipeline.calculate_center_of_mass(seg, 19),
                          jax_pipeline.calculate_center_of_mass(seg, 19))
    root = write_raw_cohort(str(tmp_path / "raw"))
    for p, suffix in (("p0", "msk"), ("p1", "seg")):
        path = f"{root}/{p}/{p}_{suffix}.nii.gz"
        mine = pipeline.write_centroid_json(path, str(tmp_path / f"{p}_t.json"))
        want = jax_pipeline.write_centroid_json(path, str(tmp_path / f"{p}_j.json"))
        assert mine == want
        assert (tmp_path / f"{p}_t.json").read_text() == (tmp_path / f"{p}_j.json").read_text()


def _outputs(out_dir, names):
    return {(k, n): nifti.load(f"{out_dir}/{k}/{n}.nii.gz")
            for n in names for k in ("CT", "label", "mask_2d")}


def _assert_same_outputs(mine_dir, want_dir, names):
    mine, want = _outputs(mine_dir, names), _outputs(want_dir, names)
    for (kind, n), img in mine.items():
        ref = want[(kind, n)]
        assert np.array_equal(img.affine, ref.affine) and img.data.shape == ref.data.shape
        if kind == "CT":  # order 1: float32 sums in another order than XLA's
            np.testing.assert_allclose(img.data, ref.data, rtol=0, atol=1e-3, err_msg=n)
        else:
            np.testing.assert_array_equal(img.data, ref.data, err_msg=f"{kind}/{n}")


def test_process_mask3d_single_centroid_and_process_data_equal_jax(tmp_path):
    """One centroid: no resample, the raw volumes are cropped as they are;
    process_data skips a patient whose files are missing."""
    root = write_raw_cohort(str(tmp_path / "raw"))
    js = tmp_path / "one.json"
    js.write_text(json.dumps([{"label": 20, "X": 50.0, "Y": 47.5, "Z": 80.0}]))
    args = (f"{root}/p0/p0.nii.gz", f"{root}/p0/p0_msk.nii.gz", str(js), [20, 21])
    got = pipeline.process_mask3d(*args, str(tmp_path / "t1"), (32, 32, 16), device="cpu")
    want = jax_pipeline.process_mask3d(*args, str(tmp_path / "j1"), (32, 32, 16))
    assert got == want == ["p0_20"]
    _assert_same_outputs(tmp_path / "t1", tmp_path / "j1", got)

    jax_pipeline.write_centroid_json(f"{root}/p2/p2_msk.nii.gz", f"{root}/p2/p2.json")
    split = {"train": {"p2": [19, 21], "missing": [20]}}
    got = pipeline.process_data(root, split, str(tmp_path / "t2"), (48, 40, 24), mask_mode="left",
                                device="cpu")
    want = jax_pipeline.process_data(root, split, str(tmp_path / "j2"), (48, 40, 24),
                                     mask_mode="left")
    assert got == want == ["p2_19", "p2_21"]
    _assert_same_outputs(tmp_path / "t2", tmp_path / "j2", got)


# ------------------------------------------------------------------ axial


def test_axial_masks_equal_jax():
    seg = np.zeros((40, 60))
    seg[10:30, 5:30] = 1
    seg[15:22, 40:55] = 1
    assert np.array_equal(axial._dilate2(seg), jax_axial._dilate2(seg))
    for a, b in zip(axial.get_vertbody(seg), jax_axial.get_vertbody(seg)):
        assert np.array_equal(a, b)
    for a, b in zip(axial.get_vertbody(np.zeros((9, 9))), jax_axial.get_vertbody(np.zeros((9, 9)))):
        assert np.array_equal(a, b)

    rng = np.random.default_rng(0)
    ct = rng.normal(100, 30, (128, 128, 20))
    labels = np.zeros((128, 128, 20))
    labels[40:70, 30:60, 5:15] = 20
    labels[71:74, 30:60, 5:15] = 21
    labels[38:40, 30:60, 5:15] = 5
    got = axial.process_spine_data(ct, labels, 20, (96, 96))
    want = jax_axial.process_spine_data(ct, labels, 20, (96, 96))
    assert got.keys() == want.keys()
    for k in got:
        assert np.array_equal(got[k], want[k]), k
    labels2 = np.zeros((64, 64, 12))
    labels2[20:30, 20:30, 2] = 22
    labels2[20:30, 20:30, 8] = 22
    assert axial.process_spine_data(ct[:64, :64, :12], labels2, 22, (48, 48)) is None
    with pytest.raises(ValueError, match="square"):
        axial.process_spine_data(ct, labels, 20, (96, 64))
