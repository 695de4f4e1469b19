"""Port vs JAX package on the CPU: the whole two-stage Generator and
generator_forward, at ngf=4 / 64 px with seeded random weights, and once at the
production shape (ngf=16, 256 px, batch 2) on the shipped weights.

Same numpy batch from a seed goes through both; JAX runs its XLA attention
path, the port the plain attention (the kernel's oracle).

Tolerances. float32: atol 1e-5 on the [-1, 1] images, the sigmoid maps
and the height fractions (~40 convs and an attention softmax with scale 10
between input and output, sums in different orders; the largest error seen
is 3e-7), and the binarised seg maps may differ only where the sigmoid lies
within 1e-5 of 0.5. The production case, with trained weights on 256 x 256
maps, allows atol 5e-5 (largest seen 7.6e-6). bfloat16: both sides round
every conv output to bf16, at different places (XLA after the conv and
again after the bias, the port once), and the differences compound through
the trunk: mean abs error <= 2e-3 and max <= 3e-2 on the maps (seen 6e-4
and 4e-3), atol 1e-3 on the float32 height fractions.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from healthivert_tpu.data.synthetic import SyntheticDataset
from healthivert_tpu.models import pix2pix as jpix
from healthivert_tpu.models.generator import Generator as JaxGenerator
from healthivert_tpu_torch.engine.checkpoint import PRETRAINED_NPZ, load_generator
from healthivert_tpu_torch.models import pix2pix
from healthivert_tpu_torch.models.generator import Generator, _bc_ratio
from healthivert_tpu_torch.models.layers import SNConv
from healthivert_tpu_torch.utils.weights import flax_to_state_dict, load_npz_trees
from torch_port_fixtures import random_generator_vars

FIELDS = ["coarse_seg", "fine_seg", "x_stage1", "x_stage2", "offsets", "pred1_h", "pred2_h"]
MAPS = ["coarse_seg", "fine_seg", "x_stage1", "x_stage2"]


def _small_batch(bs=2, size=64, seed=3):
    opt = types.SimpleNamespace(batch_size=bs, seed=seed, crop_size=size)
    return SyntheticDataset(opt, batch_size=bs, seed=seed, n_volumes=2).sample_batch()


def _port(v, cnum, dtype=None):
    gen = Generator(cnum=cnum, dtype=dtype)
    gen.load_state_dict(flax_to_state_dict(v["params"], v["sn"]))
    return gen.eval()


def _gen_inputs(batch):
    return (batch["context"], batch["mask"], 1.0 - batch["cam"], batch["slice_ratio"])


def _f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32)) if not isinstance(a, torch.Tensor) \
        else a.float().numpy()


@pytest.fixture(scope="module")
def small():
    batch = _small_batch()
    return batch, random_generator_vars(4)


def test_generator_f32(small):
    batch, v = small
    want = JaxGenerator(cnum=4).apply(v, *map(jnp.asarray, _gen_inputs(batch)))
    with torch.no_grad():
        got = _port(v, 4)(*map(torch.from_numpy, _gen_inputs(batch)))
    for name in FIELDS:
        w, g = np.asarray(getattr(want, name)), getattr(got, name).numpy()
        assert g.shape == w.shape and g.dtype == w.dtype, name
        if name == "offsets":
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, atol=1e-5, rtol=0, err_msg=name)


def _forward_both(batch, v, cnum, compute_dtype):
    jcfg = jpix.Pix2PixConfig(ngf=cnum, image_size=batch["full"].shape[1],
                              compute_dtype=compute_dtype)
    jgen = jpix.build_modules(jcfg)[0]
    want = jpix.generator_forward(
        jgen, v["params"], v["sn"], {k: jnp.asarray(a) for k, a in batch.items()},
        jcfg, update_sn=False,
    )
    cfg = pix2pix.Pix2PixConfig(ngf=cnum, image_size=batch["full"].shape[1],
                                compute_dtype=compute_dtype)
    gen = _port(v, cnum, cfg.module_dtype)
    with torch.no_grad():
        got = pix2pix.generator_forward(
            gen, {k: torch.from_numpy(np.asarray(a)) for k, a in batch.items()}, cfg
        )
    return want, got


def _check_binarised(got_bin, got_soft, want_bin, tol):
    """Binary maps agree except where the sigmoid sits within tol of 0.5."""
    diff = got_bin != want_bin
    assert np.all(np.abs(got_soft[diff] - 0.5) <= tol)


def test_generator_forward_f32(small):
    batch, v = small
    want, got = _forward_both(batch, v, 4, "float32")
    assert set(got) == set(want) - {"new_sn"}
    for key in ["pred1_h", "pred2_h", "fake_b", "fake_b_coarse", "fake_local",
                "real_local", "real_edges"]:
        w, g = np.asarray(want[key]), got[key].numpy()
        assert g.shape == w.shape and g.dtype == w.dtype, key
        np.testing.assert_allclose(g, w, atol=1e-5 * 40 if "pred" in key else 1e-5,
                                   rtol=0, err_msg=key)
    _check_binarised(got["fine_seg_bin"].numpy(), got["gen"].fine_seg.numpy(),
                     np.asarray(want["fine_seg_bin"]), 1e-5)
    _check_binarised(got["coarse_seg_bin"].numpy(), got["gen"].coarse_seg.numpy(),
                     np.asarray(want["coarse_seg_bin"]), 1e-5)
    same = np.array_equal(got["fine_seg_bin"].numpy(), np.asarray(want["fine_seg_bin"]))
    if same:
        np.testing.assert_allclose(got["fake_edges"].numpy(),
                                   np.asarray(want["fake_edges"]), atol=1e-6)


def test_generator_forward_bf16(small):
    batch, v = small
    want, got = _forward_both(batch, v, 4, "bfloat16")
    for name in MAPS:
        w, g = _f32(getattr(want["gen"], name)), _f32(getattr(got["gen"], name))
        assert getattr(got["gen"], name).dtype == torch.bfloat16, name
        err = np.abs(g - w)
        assert err.mean() <= 2e-3 and err.max() <= 3e-2, (name, err.mean(), err.max())
    for name in ["pred1_h", "pred2_h"]:
        assert getattr(got["gen"], name).dtype == torch.float32
        np.testing.assert_allclose(_f32(getattr(got["gen"], name)),
                                   _f32(getattr(want["gen"], name)), atol=1e-3)
    assert got["fake_b"].dtype == torch.bfloat16
    assert got["fake_local"].dtype == torch.float32  # bf16 x f32 centre mask


def test_bf16_mode_stays_bf16_end_to_end(small):
    """The ratio plane follows the image dtype, so in bf16 mode every conv
    sees a bf16 input (a float32 plane would promote the whole trunk)."""
    batch, v = small
    assert _bc_ratio(torch.ones(2), 4, 4, torch.bfloat16).dtype == torch.bfloat16
    assert _bc_ratio(torch.ones(2), 4, 4).shape == (2, 4, 4, 1)
    cfg = pix2pix.Pix2PixConfig(ngf=4, image_size=64, compute_dtype="bfloat16")
    gen = _port(v, 4, cfg.module_dtype)
    seen = []
    for m in gen.modules():
        if isinstance(m, SNConv):
            m.register_forward_pre_hook(lambda mod, args: seen.append(args[0].dtype))
    with torch.no_grad():
        pix2pix.generator_forward(
            gen, {k: torch.from_numpy(np.asarray(a)) for k, a in batch.items()}, cfg
        )
    assert len(seen) == sum(isinstance(m, SNConv) for m in gen.modules())
    assert set(seen) == {torch.bfloat16}


def test_generator_forward_refuses_training_and_int8():
    """update_sn=True stays refused; int8 builds: an int8 generator whose
    wide convs quantize and whose 1-channel heads run bf16, and bf16
    discriminators (held against the JAX package in tests/test_torch_int8.py)."""
    cfg = pix2pix.Pix2PixConfig(ngf=16, compute_dtype="int8")
    gen, discs = pix2pix.build_modules(cfg)
    assert gen.dtype == cfg.module_dtype == "int8" and cfg.disc_dtype == torch.bfloat16
    convs = [m for m in gen.modules() if isinstance(m, SNConv)]
    assert all(m.dtype == "int8" for m in convs)
    assert sum(m.weight.shape[0] >= 8 for m in convs) == 43
    assert all(d.dtype == torch.bfloat16 for d in discs)
    with pytest.raises(NotImplementedError):
        pix2pix.Pix2PixConfig(compute_dtype="float16")
    with pytest.raises(NotImplementedError):
        pix2pix.generator_forward(None, {}, pix2pix.Pix2PixConfig(), update_sn=True)


def test_shipped_weights_production_shape():
    """ngf=16, 256 x 256, batch 2, float32, shipped weights: all seven
    GeneratorOut fields plus fake_b."""
    batch = SyntheticDataset(batch_size=2, seed=0, n_volumes=2).sample_batch()
    params, sn = load_npz_trees(PRETRAINED_NPZ)
    jcfg = jpix.Pix2PixConfig(ngf=16, image_size=256)
    want = jax.jit(
        lambda p, s, b: jpix.generator_forward(
            jpix.build_modules(jcfg)[0], p, s, b, jcfg, update_sn=False)
    )(params, sn, {k: jnp.asarray(a) for k, a in batch.items()})
    cfg = pix2pix.Pix2PixConfig(ngf=16, image_size=256)
    gen = load_generator(PRETRAINED_NPZ, cfg, device="cpu")
    with torch.no_grad():
        got = pix2pix.generator_forward(
            gen, {k: torch.from_numpy(np.asarray(a)) for k, a in batch.items()}, cfg
        )
    for name in FIELDS:
        w, g = np.asarray(getattr(want["gen"], name)), getattr(got["gen"], name).numpy()
        assert g.shape == w.shape, name
        if name == "offsets":
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, atol=5e-5, rtol=0, err_msg=name)
    np.testing.assert_allclose(got["fake_b"].numpy(), np.asarray(want["fake_b"]),
                               atol=5e-5, rtol=0)
