"""Port vs JAX package on the CPU: spectral-norm conv blocks, nearest resize,
Sobel edges, SHRM paste-back and the centre-column mask.

Same numpy inputs from a seed go through both; weights are the flax
initialisation carried over by utils/weights.py.

Tolerances. float32 convs: atol 2e-5 on outputs of magnitude ~1 (XLA and
oneDNN sum the <= 9*64 products in different orders). bfloat16 convs:
atol 3e-2 and rtol 2e-2, i.e. about two bf16 ulps (2^-8 relative): the JAX
layer rounds the conv output to bf16 and again after adding the bias, the
port rounds once. Resize, paste and the mask are gathers: exact. Sobel is
six float32 adds and a sqrt: atol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from healthivert_tpu.models.layers import Conv2dBlock as JaxConv2dBlock
from healthivert_tpu.ops import geometry as jgeo
from healthivert_tpu.ops import image as jimage
from healthivert_tpu_torch.models.layers import Conv2dBlock, spectral_normalize
from healthivert_tpu_torch.ops import geometry, image
from healthivert_tpu_torch.utils.weights import flax_to_state_dict

ACTS = ["relu", "elu", "lrelu", "tanh", "sigmoid", "none"]


def _pair(rng, fin, features, k, s, p, r, act, dtype=None, hw=20):
    """(JAX output, port output) of one Conv2dBlock on the same input."""
    x = rng.standard_normal((2, hw, hw, fin)).astype(np.float32)
    jblock = JaxConv2dBlock(features, k, s, p, r, act, dtype=dtype and jnp.bfloat16)
    v = jblock.init(jax.random.PRNGKey(int(rng.integers(1 << 30))), jnp.asarray(x))
    # a u that is not the init's, so the power iteration is really exercised
    u = rng.standard_normal(features).astype(np.float32)
    v = {"params": v["params"], "sn": {"conv": {"u": u / np.linalg.norm(u)}}}
    want = np.asarray(jblock.apply(v, jnp.asarray(x)).astype(jnp.float32))
    block = Conv2dBlock(fin, features, k, s, p, r, act, dtype=dtype)
    block.load_state_dict(flax_to_state_dict(v["params"], v["sn"]))
    with torch.no_grad():
        got = block(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    return want, got


@pytest.mark.parametrize("act", ACTS)
def test_conv_block_every_activation(rng, act):
    want, got = _pair(rng, 3, 8, 3, 1, 1, 1, act)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=0)


@pytest.mark.parametrize(
    "k,s,p,r", [(3, 2, 1, 1), (5, 1, 2, 1), (3, 1, 16, 16), (3, 1, 2, 2)],
    ids=["stride2", "k5", "dilation16", "dilation2"],
)
def test_conv_block_geometry(rng, k, s, p, r):
    want, got = _pair(rng, 6, 12, k, s, p, r, "elu", hw=40)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=0)


@pytest.mark.parametrize("act", ["elu", "sigmoid", "relu"])
def test_conv_block_bf16(rng, act):
    want, got = _pair(rng, 5, 16, 3, 1, 1, 1, act, dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=3e-2, rtol=2e-2)


def test_spectral_norm_matches_flax_formula(rng):
    """sigma from one power iteration, independent of the flattening order
    of the kernel (HWIO reshaped in flax, OIHW here)."""
    k = rng.standard_normal((3, 3, 4, 6)).astype(np.float32)  # HWIO
    u = rng.standard_normal(6).astype(np.float32)
    mat = k.reshape(-1, 6).T
    l2 = lambda a: a / (np.linalg.norm(a) + 1e-12)
    v = l2(mat.T @ u)
    u_new = l2(mat @ v)
    sigma = u_new @ (mat @ v)
    got = spectral_normalize(torch.from_numpy(k.transpose(3, 2, 0, 1).copy()),
                             torch.from_numpy(u))
    np.testing.assert_allclose(got.numpy(), (k / sigma).transpose(3, 2, 0, 1), rtol=2e-6)


@torch.no_grad()
def test_sn_cache_follows_weight_updates(rng):
    """Without autograd the normalized kernel is cached per weight version."""
    block = Conv2dBlock(2, 3, 3, 1, 1)
    block.conv.weight.copy_(torch.randn(3, 2, 3, 3))
    first = block.conv.normalized_weight().clone()
    assert block.conv.normalized_weight() is block.conv.normalized_weight()
    block.conv.weight.mul_(2.0)
    second = block.conv.normalized_weight()
    # spectral normalisation is scale invariant, so the value stays ...
    torch.testing.assert_close(first, second, rtol=1e-5, atol=1e-6)
    # ... but it was recomputed from the new weight
    block.conv.weight[0].zero_()
    assert float(block.conv.normalized_weight()[0].abs().sum()) == 0.0


def test_sn_under_autograd_is_live_and_uncached():
    block = Conv2dBlock(2, 3, 3, 1, 1)
    with torch.no_grad():
        block.conv.weight.copy_(torch.randn(3, 2, 3, 3))
        cached = block.conv.normalized_weight()
    live = block.conv.normalized_weight()
    assert live.requires_grad and live is not block.conv.normalized_weight()
    torch.testing.assert_close(live.detach(), cached)


@pytest.mark.parametrize(
    "src,dst", [((8, 8), (16, 16)), ((16, 12), (8, 6)), ((10, 10), (7, 7)),
                ((7, 9), (10, 20)), ((8, 8), (8, 8))],
)
def test_resize_nearest(rng, src, dst):
    x = rng.standard_normal((2,) + src + (3,)).astype(np.float32)
    want = np.asarray(jimage.resize_nearest(jnp.asarray(x), *dst))
    got = image.resize_nearest(torch.from_numpy(x), *dst)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("binary", [False, True], ids=["soft", "binary"])
def test_sobel_edges(rng, binary):
    x = rng.random((2, 17, 13, 1)).astype(np.float32)
    if binary:
        x = (x > 0.5).astype(np.float32)
    want = np.asarray(jimage.sobel_edges(jnp.asarray(x)))
    got = image.sobel_edges(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)


def test_sobel_edges_bf16_dtype(rng):
    x = torch.from_numpy((rng.random((1, 8, 8, 1)) > 0.5).astype(np.float32))
    assert image.sobel_edges(x.to(torch.bfloat16)).dtype == torch.bfloat16


def _paste_inputs(rng, n=6, h=48, w=12):
    fake = rng.standard_normal((n, h, w, 1)).astype(np.float32)
    real = rng.standard_normal((n, h, w, 1)).astype(np.float32)
    x1 = rng.integers(0, h - 20, n).astype(np.int32)
    height = rng.integers(4, 16, n).astype(np.int32)
    x2 = (x1 + height).astype(np.int32)
    # predicted heights below, at and above the real one, fractional
    pred = (height + rng.uniform(-3, 8, n)).astype(np.float32)
    pred[0] = height[0]  # ceil of an exact integer
    return fake, real, pred, height, x1, x2


def test_shrm_paste_batch(rng):
    args = _paste_inputs(rng)
    want = np.asarray(jgeo.shrm_paste_batch(*map(jnp.asarray, args)))
    got = geometry.shrm_paste_batch(*map(torch.from_numpy, args))
    np.testing.assert_array_equal(got.numpy(), want)


def test_shrm_paste_single_slice(rng):
    fake, real, pred, height, x1, x2 = _paste_inputs(rng, n=2, h=40, w=8)
    for i in range(2):
        want = np.asarray(jgeo.shrm_paste(
            jnp.asarray(fake[i, :, :, 0]), jnp.asarray(real[i, :, :, 0]),
            pred[i], height[i], x1[i], x2[i],
        ))
        got = geometry.shrm_paste(
            torch.from_numpy(fake[i, :, :, 0]), torch.from_numpy(real[i, :, :, 0]),
            float(pred[i]), int(height[i]), int(x1[i]), int(x2[i]),
        )
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("hw", [(256, 256), (64, 96)])
def test_local_crop_mask(hw):
    want = np.asarray(jgeo.local_crop_mask(*hw))
    np.testing.assert_array_equal(geometry.local_crop_mask(*hw).numpy(), want)
