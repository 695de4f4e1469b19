"""Port vs JAX package: the evaluation metrics, evaluate_model, the flow
image, and the PNG gallery.

- dice_score, iou_score, psnr, ssim and psnr_ssim_batch against
  healthivert_tpu.ops.image on the same numpy inputs: rtol 1e-5 (float32
  sums in the same order; seen <= 1e-7).
- evaluate_model on the same random generator (ngf=4, 64 x 64, float32)
  and the same two batches (3 and 2 samples): SSIM and PSNR rtol 1e-4.
  Dice and IoU are means of per-sample ratios of binarised masks, and a
  float32 difference of ~1e-7 at a seg value on the 0.5 threshold flips a
  pixel: one flipped pixel moves a sample's Dice or IoU by at most
  ~2 / (foreground pixels), and the smallest foreground here holds over
  100, so they are held within 0.02 / (samples); diff_h (the predicted
  height, no threshold) to rtol 1e-4. The grid PNG has the JAX grid's
  shape, within one grey level on all but 0.1 % of its pixels.
- flow_viz: equal.
- save_images: every PNG, decoded by PIL, equal pixel for pixel to the JAX
  package's (PIL-written) PNG; with --aspect_ratio 2 and 0.5 (PIL's
  BICUBIC in the JAX package, the port's own cubic) within one grey level.
"""

import os

import numpy as np
import pytest
import torch
from PIL import Image

from healthivert_tpu.data.synthetic import SyntheticDataset
from healthivert_tpu.engine import evaluate as jeval
from healthivert_tpu.engine import visualizer as jvis
from healthivert_tpu.models.pix2pix import Pix2PixConfig as JaxConfig
from healthivert_tpu.ops import flow_viz as jflow
from healthivert_tpu.ops import image as jimage
from healthivert_tpu_torch.engine import evaluate, visualizer
from healthivert_tpu_torch.models.generator import Generator
from healthivert_tpu_torch.models.pix2pix import Pix2PixConfig
from healthivert_tpu_torch.ops import flow_viz
from healthivert_tpu_torch.ops import image
from healthivert_tpu_torch.utils.weights import flax_to_state_dict
from torch_port_fixtures import random_generator_vars
from torch_port_fixtures import one_torch_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def test_metrics_match():
    rng = np.random.default_rng(0)
    a = rng.random((4, 40, 33)).astype(np.float32) * 2 - 1
    b = np.clip(a + 0.1 * rng.standard_normal(a.shape).astype(np.float32), -1, 1)
    dr = rng.uniform(0.5, 2.0, 4).astype(np.float32)
    m1 = (rng.random((50, 60)) > 0.6).astype(np.float32)
    m2 = (rng.random((50, 60)) > 0.5).astype(np.float32)
    t = torch.from_numpy
    close = lambda got, want: np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                                         rtol=1e-5, atol=0)
    close(image.dice_score(t(m1), t(m2)), jimage.dice_score(m1, m2))
    close(image.iou_score(t(m1), t(m2)), jimage.iou_score(m1, m2))
    close(image.psnr(t(a[0]), t(b[0]), 1.7), jimage.psnr(a[0], b[0], 1.7))
    close(image.ssim(t(a[0]), t(b[0]), 1.7), jimage.ssim(a[0], b[0], 1.7))
    pg, sg = image.psnr_ssim_batch(t(a), t(b), t(dr))
    pw, sw = jimage.psnr_ssim_batch(a, b, dr)
    close(pg, pw)
    close(sg, sw)
    assert image.psnr_ssim_batch(t(a), t(b), t(dr), with_ssim=False)[1] is None


def test_flow_viz_equal():
    rng = np.random.default_rng(1)
    offsets = rng.integers(0, 8, (2, 8, 8, 2)).astype(np.int32)
    np.testing.assert_array_equal(flow_viz.offsets_to_flow_image(offsets),
                                  jflow.offsets_to_flow_image(offsets))
    flow = rng.normal(0, 3, (1, 5, 7, 2))
    flow[0, 0, 0] = np.nan
    np.testing.assert_array_equal(flow_viz.flow_to_image(flow), jflow.flow_to_image(flow))


def test_evaluate_model_matches_jax(tmp_path):
    v = random_generator_vars(4, seed=2)
    ds = SyntheticDataset(batch_size=3, seed=0, shape=(64, 64, 16), vert_ids=(19, 20),
                          vert_height=14, gap=8)
    batches = [{k: np.asarray(x) for k, x in ds.sample_batch().items()} for _ in range(2)]
    batches[1] = {k: x[:2] for k, x in batches[1].items()}  # a short trailing batch
    want = jeval.evaluate_model(v["params"], v["sn"], batches, JaxConfig(ngf=4, image_size=64),
                                out_dir=str(tmp_path / "jax"), epoch=1)
    gen = Generator(cnum=4)
    gen.load_state_dict(flax_to_state_dict(v["params"], v["sn"]))
    got = evaluate.evaluate_model(gen, batches, Pix2PixConfig(ngf=4, image_size=64),
                                  out_dir=str(tmp_path / "port"), epoch=1)
    assert got.keys() == want.keys()
    for k in ("ssim", "psnr", "diff_h"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)
    for k in ("dice", "iou"):
        assert abs(got[k] - want[k]) <= 0.02 / 5, (k, got[k], want[k])
    assert np.isfinite(list(got.values())).all()
    name = "nepoch_001_eval.png"
    g = np.asarray(Image.open(tmp_path / "port" / name)).astype(int)
    w = np.asarray(Image.open(tmp_path / "jax" / name)).astype(int)
    assert g.shape == w.shape == (2 * 64, 8 * 64)
    assert np.mean(np.abs(g - w) > 1) <= 1e-3


def _visuals(rng):
    return {
        "real_A": rng.uniform(-1, 1, (24, 20, 1)).astype(np.float32),
        "fake_B_mask": (rng.random((24, 20, 1)) > 0.5).astype(np.float32),
        "CAM": rng.random((24, 20, 1)).astype(np.float32),
        "offset_flow": rng.random((24, 20, 3)).astype(np.float32),
    }


@pytest.mark.parametrize("ar", [1.0, 2.0, 0.5])
def test_save_images_pngs_match_pil(tmp_path, ar):
    vis = _visuals(np.random.default_rng(3))
    jg = jvis.HTMLGallery(str(tmp_path / "jax"), "t")
    pg = visualizer.HTMLGallery(str(tmp_path / "port"), "t")
    jvis.save_images(jg, vis, "0000", aspect_ratio=ar)
    visualizer.save_images(pg, vis, "0000", aspect_ratio=ar)
    jg.save()
    pg.save()
    assert (tmp_path / "port" / "index.html").read_text() == \
        (tmp_path / "jax" / "index.html").read_text()
    names = sorted(os.listdir(tmp_path / "jax" / "images"))
    assert names == sorted(os.listdir(tmp_path / "port" / "images")) and len(names) == 4
    for n in names:
        w = np.asarray(Image.open(tmp_path / "jax" / "images" / n)).astype(int)
        g = np.asarray(Image.open(tmp_path / "port" / "images" / n)).astype(int)
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= (0 if ar == 1.0 else 1), n
        np.testing.assert_array_equal(visualizer.read_png(tmp_path / "port" / "images" / n), g)


def test_bicubic_resize_within_one_level_of_pil():
    rng = np.random.default_rng(4)
    for shape, size in (((64, 64), (64, 128)), ((64, 64), (128, 64)), ((30, 47, 3), (30, 101)),
                        ((50, 70), (35, 90))):
        a = rng.integers(0, 256, shape).astype(np.uint8)
        want = np.asarray(Image.fromarray(a).resize(size, Image.BICUBIC)).astype(int)
        got = visualizer.resize_bicubic(a, *size).astype(int)
        assert got.shape == want.shape and np.abs(got - want).max() <= 1
