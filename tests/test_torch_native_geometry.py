"""The port's binding of native/geometry.cpp (healthivert_tpu_torch/ops/
native_geometry.py) against the JAX package's binding of the same source
and against the plain numpy versions: connected components, the minimum-
area rectangle and the convex-quad fill, on empty, single-point, duplicate
and collinear inputs as well as random ones; and the build raises on a
compiler error instead of falling back."""

import numpy as np
import pytest

from healthivert_tpu.ops import native_geometry as jng
from healthivert_tpu_torch.ops import native_geometry as ng


def _images():
    rng = np.random.default_rng(0)
    diag = np.eye(9, dtype=np.uint8)  # one component under 8-connectivity
    diag[0, 8] = diag[8, 0] = 1
    blobs = (rng.random((40, 33)) > 0.6).astype(np.uint8) * 255
    return {"empty": np.zeros((7, 5), np.uint8), "one_pixel": np.pad([[1]], ((3, 2), (1, 4))),
            "full": np.ones((6, 4), np.uint8), "diagonal": diag, "blobs": blobs,
            "bool": rng.random((16, 16)) > 0.5}


@pytest.mark.parametrize("name", list(_images()))
def test_cc_label_equals_jax_and_scipy(name):
    img = _images()[name]
    labels, n = ng.cc_label(img)
    want, want_n = jng.cc_label(img)
    ref, ref_n = ng.cc_label_reference(img)
    assert labels.dtype == np.int32 and n == want_n == ref_n
    np.testing.assert_array_equal(labels, want)
    np.testing.assert_array_equal(labels, ref)


def _point_sets():
    rng = np.random.default_rng(1)
    return {"single": np.array([[3.0, 4.0]]), "duplicates": np.tile([[7.0, 3.0]], (5, 1)),
            "collinear_diagonal": np.array([[0, 0], [1, 1], [2, 2], [5, 5.0]]),
            "collinear_row": np.array([[0, 2], [3, 2], [7, 2.0], [3, 2]]),
            "two_points": np.array([[1.0, 9.0], [4.0, 2.0]]),
            "rectangle": np.array([[1, 1], [1, 5], [4, 1], [4, 5.0]]),
            "integer_cloud": rng.integers(0, 30, (40, 2)).astype(np.float64),
            "gaussian": rng.normal(0, 10, (60, 2)),
            "body_slice": np.argwhere(rng.random((20, 30)) > 0.3)[:, ::-1].astype(np.float64)}


@pytest.mark.parametrize("name", list(_point_sets()))
def test_min_area_rect_equals_jax_and_numpy(name):
    pts = _point_sets()[name]
    corners, center = ng.min_area_rect(pts)
    want_c, want_ctr = jng.min_area_rect(pts)
    ref_c, ref_ctr = ng.min_area_rect_reference(pts)
    np.testing.assert_array_equal(corners, want_c)
    np.testing.assert_array_equal(center, want_ctr)
    np.testing.assert_allclose(corners, ref_c, rtol=0, atol=1e-9)
    np.testing.assert_allclose(center, ref_ctr, rtol=0, atol=1e-9)


def test_min_area_rect_rejects_empty_and_misshapen_points():
    for fn in (ng.min_area_rect, ng.min_area_rect_reference):
        with pytest.raises(ValueError, match="empty"):
            fn(np.zeros((0, 2)))
    with pytest.raises(ValueError, match=r"\(n, 2\)"):
        ng.min_area_rect(np.zeros((4, 3)))


def _quads():
    rng = np.random.default_rng(2)
    out = {"point": np.tile([[5.0, 6.0]], (4, 1)),
           "row": np.array([[2, 3], [9, 3], [9, 3], [2, 3.0]]),
           "outside": np.array([[-5.4, -3.0], [40.2, -3.0], [40.2, 50.6], [-5.4, 50.6]]),
           "half_ties": np.array([[0.5, 0.5], [10.5, 2.5], [8.5, 12.5], [-1.5, 10.5]])}
    for k in range(6):  # the de-pedicle masks' quads: 1.1 x min-area rects
        corners, center = ng.min_area_rect(rng.integers(0, 30, (8, 2)).astype(np.float64))
        out[f"scaled_rect{k}"] = (corners - center) * 1.1 + center
    return out


@pytest.mark.parametrize("name", list(_quads()))
def test_fill_convex_quad_equals_jax_and_numpy(name):
    quad = _quads()[name]
    img = ng.fill_convex_quad(quad, (32, 36), 255)
    assert img.dtype == np.uint8 and img.shape == (32, 36)
    np.testing.assert_array_equal(img, jng.fill_convex_quad(quad, (32, 36), 255))
    np.testing.assert_array_equal(img, ng.fill_convex_quad_reference(quad, (32, 36), 255))
    np.testing.assert_array_equal(ng.fill_convex_quad(quad, (32, 36), 7) > 0, img > 0)


def test_library_is_built_into_the_port_build_dir():
    lib = ng.load_library()
    path = ng.build()
    assert path.parent == ng.BUILD_DIR and path.name.startswith("hv_geometry_")
    assert lib is ng.load_library()


def test_build_raises_with_the_compiler_message(tmp_path, monkeypatch):
    bad = tmp_path / "geometry.cpp"
    bad.write_text('extern "C" int cc_label( { this is not C++ }\n')
    monkeypatch.setattr(ng, "SOURCE", bad)
    monkeypatch.setattr(ng, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="native geometry: .*failed") as err:
        ng.build()
    assert "error" in str(err.value)
    assert not any((tmp_path / "build").glob("*.so"))
    monkeypatch.setenv("CXX", "no-such-compiler-hv")
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        ng.build()
