"""Port vs JAX package on the CPU: the three-pass 3D synthesis.

`synthesize_volume` at ngf=4 on a (64, 64, 16) synthetic spine, as in
tests/test_engine.py, with the same seeded random weights on both sides
and use_bf16=False.

Tolerance. The synthesis turns float outputs into discrete ones: the predicted
height goes through ceil(), the seg through > 0.5, the CT through uint8
rounding, and each pass feeds the next. Float32 differences of ~1e-7 can
flip one of these where a value sits on the edge, so: |delta CT| <= 1 grey
level everywhere, and labels agree on >= 99.9 % of voxels (seen: both
volumes equal).
"""

import numpy as np
import pytest
import torch

from healthivert_tpu.data.synthetic import make_spine_volume as jax_make_spine_volume
from healthivert_tpu.engine.infer3d import synthesize_volume as jax_synthesize_volume
from healthivert_tpu.models.pix2pix import Pix2PixConfig as JaxConfig
from healthivert_tpu_torch.data.synthetic import make_spine_volume
from healthivert_tpu_torch.engine import infer3d
from healthivert_tpu_torch.models.generator import Generator
from healthivert_tpu_torch.models.pix2pix import Pix2PixConfig
from healthivert_tpu_torch.utils.weights import flax_to_state_dict
from torch_port_fixtures import random_generator_vars


def _spine(seed=0):
    return make_spine_volume(
        np.random.default_rng(seed), shape=(64, 64, 16), vert_ids=(19, 20, 21),
        vert_height=12, gap=5, fractured={20: 0.6},
    )


@pytest.fixture(scope="module")
def weights():
    return random_generator_vars(4)


def _port_gen(v, dtype=None):
    gen = Generator(cnum=4, dtype=dtype)
    gen.load_state_dict(flax_to_state_dict(v["params"], v["sn"]))
    return gen.eval()


def test_synthetic_volume_is_a_copy():
    for a, b in zip(_spine(), jax_make_spine_volume(
            np.random.default_rng(0), shape=(64, 64, 16), vert_ids=(19, 20, 21),
            vert_height=12, gap=5, fractured={20: 0.6})):
        np.testing.assert_array_equal(a, b)


def test_synthesize_volume_matches_jax(weights):
    ct, labels, cam = _spine()
    want_ct, want_lb = jax_synthesize_volume(
        weights["params"], weights["sn"], JaxConfig(ngf=4, image_size=64),
        ct, labels, 20, cam, batch_size=8, use_bf16=False,
    )
    before = infer3d._forward.dispatches
    got_ct, got_lb = infer3d.synthesize_volume(
        _port_gen(weights), Pix2PixConfig(ngf=4, image_size=64),
        ct, labels, 20, cam, batch_size=8, use_bf16=False, device="cpu",
    )
    assert infer3d._forward.dispatches > before
    assert got_ct.shape == ct.shape and got_lb.shape == labels.shape
    assert np.abs(got_ct - want_ct).max() <= 1.0
    assert np.mean(got_lb == want_lb) >= 0.999
    zs = np.nonzero((labels == 20).any(axis=(0, 1)))[0]
    z_mid = (zs.min() + zs.max()) // 2
    assert got_ct[:, :, z_mid].max() > 0 and got_ct[:, :, 0].max() == 0


def test_band_inputs_match_jax(rng):
    from healthivert_tpu.engine.infer3d import _band_inputs as jax_band_inputs

    ct = rng.integers(0, 256, (3, 64, 8)).astype(np.uint8)
    cam = rng.integers(0, 256, (3, 64, 8)).astype(np.uint8)
    x1, x2 = np.array([5, 30, 44]), np.array([17, 42, 60])
    min_x, max_x = np.array([0, 16, 24]), np.array([40, 56, 64])
    got = infer3d._band_inputs(*map(torch.from_numpy, (ct, cam, x1, x2, min_x, max_x)))
    for i in range(3):
        want = jax_band_inputs(ct[i], cam[i], x1[i], x2[i], min_x[i], max_x[i])
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g[i].numpy(), np.asarray(w))


def test_cam_bucket_and_window_match_jax():
    from healthivert_tpu.engine import infer3d as jinfer

    for n in (1, 16, 17, 64, 65, 200):
        assert infer3d._cam_bucket(n) == jinfer._cam_bucket(n)
    assert (infer3d.WINDOW, infer3d.MAXHEIGHT) == (jinfer.WINDOW, jinfer.MAXHEIGHT)


def test_unported_options_raise(weights):
    ct, labels, cam = _spine()
    gen, cfg = _port_gen(weights), Pix2PixConfig(ngf=4, image_size=64)
    vols = [(ct, labels, 20, cam)]
    with pytest.raises(TypeError, match="Mesh"):  # a mesh is parallel.mesh's
        infer3d.synthesize_volumes(gen, cfg, vols, mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="int8"):
        infer3d.synthesize_volumes(gen, cfg, vols, quant="auto", device="cpu")
    with pytest.raises(ValueError, match="use_bf16"):
        infer3d.synthesize_volumes(gen, cfg, vols, use_bf16=True, device="cpu")


def test_entry_point_refuses_missing_cuda(weights, monkeypatch):
    ct, labels, cam = _spine()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        infer3d.synthesize_volume(_port_gen(weights), Pix2PixConfig(ngf=4, image_size=64),
                                  ct, labels, 20, cam, use_bf16=False)
