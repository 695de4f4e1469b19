"""Port vs JAX package on the CPU: the host-side modules of the last slice,
data/transforms.py (with ops/resample.py), data/image_folder.py,
utils/image_pool.py and utils/get_data.py.

- resize and get_transform: the JAX package resizes through PIL's mode
  "F"; the port through its numpy copy of PIL's resample. Every
  --preprocess mode with each of the four filters, and resize alone at
  upscale, downscale and odd sizes, on 0-255 data: atol 1e-4 (seen equal);
  the uint8 bicubic of engine/visualizer.resize_bicubic still equals PIL's;
- ImagePool: bit-equal batches over 20 queries for the same seed;
- make_dataset: the same files in the same order on a temp tree;
- GetData: with urllib.request.urlretrieve replaced (no network), a failed
  download raises RuntimeError in both packages, and a local .tar.gz is
  extracted and removed.
"""

import io
import os
import tarfile
import types
import urllib.request

import numpy as np
import pytest
from PIL import Image

from healthivert_tpu.data import image_folder as jfolder
from healthivert_tpu.data import transforms as jtf
from healthivert_tpu.utils import get_data as jget
from healthivert_tpu.utils import image_pool as jpool
from healthivert_tpu_torch.data import image_folder, transforms
from healthivert_tpu_torch.engine.visualizer import resize_bicubic
from healthivert_tpu_torch.utils import get_data, image_pool

METHODS = ["bicubic", "bilinear", "nearest", "lanczos"]
PREPROCESS = ["none", "resize", "resize_and_crop", "crop", "scale_width",
              "scale_width_and_crop"]


@pytest.mark.parametrize("method", METHODS)
def test_resize_matches_pil(rng, method):
    for h, w in [(17, 23), (64, 64), (30, 41)]:
        img = (255.0 * rng.random((h, w))).astype(np.float64)
        for nh, nw in [(8, 8), (64, 48), (37, 19), (128, 100), (h, w + 1), (5, 90)]:
            want = jtf.resize(img, nh, nw, method)
            got = transforms.resize(img, nh, nw, method)
            assert got.shape == want.shape == (nh, nw) and got.dtype == np.float64
            np.testing.assert_allclose(got, want, atol=1e-4, rtol=0,
                                       err_msg=f"{method} {h}x{w} -> {nh}x{nw}")


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("preprocess", PREPROCESS)
def test_get_transform_matches_jax(rng, preprocess, method):
    opt = types.SimpleNamespace(preprocess=preprocess, load_size=40, crop_size=32,
                                no_flip=False)
    img = 255.0 * rng.random((45, 62))
    for seed in range(3):
        params = jtf.get_params(opt, (62, 45), rng=np.random.default_rng(seed))
        assert transforms.get_params(opt, (62, 45), rng=np.random.default_rng(seed)) == params
        for kw in (dict(params=params, convert=False), dict(rng=seed, convert=False),
                   dict(params=params)):
            # each package draws from its own generator of the same seed
            fresh = lambda: {**kw, "rng": np.random.default_rng(kw["rng"])} if "rng" in kw else kw
            want = jtf.get_transform(opt, method=method, **fresh())(img)
            got = transforms.get_transform(opt, method=method, **fresh())(img)
            assert got.shape == want.shape and got.dtype == want.dtype
            scale = 1.0 if kw.get("convert") is False else 127.5  # back to 0-255
            np.testing.assert_allclose(got * scale, want * scale, atol=1e-4, rtol=0)


def test_make_power_2_and_resize_bilinear(rng):
    img = 255.0 * rng.random((45, 62))
    want = jtf.make_power_2(img)
    assert want.shape == (44, 64)
    np.testing.assert_allclose(transforms.make_power_2(img), want, atol=1e-4, rtol=0)
    even = img[:44, :60]
    assert transforms.make_power_2(even) is even
    np.testing.assert_array_equal(transforms.resize_bilinear(img, 30, 70),
                                  jtf.resize_bilinear(img, 30, 70))


def test_visualizer_bicubic_still_equals_pil(rng):
    for shape, (ow, oh) in [((17, 23), (40, 9)), ((64, 64, 3), (32, 96)), ((30, 41), (41, 30))]:
        img = (255 * rng.random(shape)).astype(np.uint8)
        want = np.asarray(Image.fromarray(img).resize((ow, oh), Image.BICUBIC))
        np.testing.assert_array_equal(resize_bicubic(img, ow, oh), want)


def test_image_pool_matches_jax(rng):
    want_pool, got_pool = jpool.ImagePool(4, seed=3), image_pool.ImagePool(4, seed=3)
    for _ in range(20):
        batch = rng.random((3, 8, 8, 1)).astype(np.float32)
        np.testing.assert_array_equal(got_pool.query(batch), want_pool.query(batch))
    assert got_pool.num_imgs == want_pool.num_imgs == 4
    off = rng.random((2, 4, 4, 1))
    assert image_pool.ImagePool(0).query(off) is off


def test_make_dataset_matches_jax(tmp_path):
    assert image_folder.IMG_EXTENSIONS == jfolder.IMG_EXTENSIONS
    for rel in ["a/1.png", "a/1_label.png", "b/c/2.nii.gz", "b/c/3.txt", "z.JPG",
                "b/0.tiff", "b/0_label.nii"]:
        (tmp_path / rel).parent.mkdir(parents=True, exist_ok=True)
        (tmp_path / rel).write_bytes(b"")
    want = jfolder.make_dataset(str(tmp_path))
    assert image_folder.make_dataset(str(tmp_path)) == want
    assert [os.path.relpath(p, tmp_path) for p in want] == ["z.JPG", "a/1.png", "b/0.tiff",
                                                             "b/c/2.nii.gz"]
    assert image_folder.make_dataset(str(tmp_path), 2) == want[:2]
    assert image_folder.is_image_file("x.nii.gz") and not image_folder.is_image_file("x.gz")
    with pytest.raises(AssertionError):
        image_folder.make_dataset(str(tmp_path / "missing"))


def _archive(name):
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w:gz") as t:
        data = b"pixels"
        info = tarfile.TarInfo(f"{name}/trainA/0.png")
        info.size = len(data)
        t.addfile(info, io.BytesIO(data))
    return buf.getvalue()


@pytest.mark.parametrize("pkg", [jget, get_data], ids=["jax", "port"])
def test_get_data_offline(tmp_path, monkeypatch, pkg):
    calls = []

    def refuse(url, path):
        calls.append(url)
        raise OSError("no route to host")

    monkeypatch.setattr(urllib.request, "urlretrieve", refuse)
    with pytest.raises(RuntimeError, match="facades"):
        pkg.GetData("pix2pix", verbose=False).get(str(tmp_path / "fail"), "facades")
    assert calls == [f"{pkg.PIX2PIX_URL}/facades.tar.gz", f"{pkg.PIX2PIX_URL}/facades.zip"]

    blob = _archive("maps")

    def local(url, path):
        assert url == f"{pkg.CYCLEGAN_URL}/maps.tar.gz"
        with open(path, "wb") as fh:
            fh.write(blob)

    monkeypatch.setattr(urllib.request, "urlretrieve", local)
    out = pkg.GetData(verbose=False).get(str(tmp_path / "ok"), "maps")
    assert out == str(tmp_path / "ok" / "maps")
    assert (tmp_path / "ok" / "maps" / "trainA" / "0.png").read_bytes() == b"pixels"
    assert not (tmp_path / "ok" / "maps.tar.gz").exists()
