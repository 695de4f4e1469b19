"""Port vs JAX package on the CPU: the Prewitt and Canny edges
(ops/edges.py) and the space-to-depth transforms (ops/s2d.py).

Inputs come from numpy seeds. Tolerances:
- Prewitt: atol 1e-5 (shifted adds, a sqrt, a clip);
- Canny: atol 1e-5 on every pixel except those whose orientation, in
  units of 45 degrees, sits within 1e-4 of a .5 rounding boundary: there an
  ulp of atan2 between XLA and ATen may pick the neighbouring direction.
  Their count is printed and must stay under 0.5 % of the pixels;
- s2d: the layout moves and the transformed kernels bit-equal to the JAX
  package's; a transformed conv on the s2d tensor equals the dense conv
  within 1e-5 of the largest |output| (the same products, summed in
  another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from healthivert_tpu.ops import edges as jedges
from healthivert_tpu.ops import s2d as js2d
from healthivert_tpu_torch.ops import edges, s2d
from healthivert_tpu_torch.ops.image import resize_nearest


def _images(rng, b=2, h=32, w=40):
    """Noise plus a bright disc and a bar: edges in every direction."""
    yy, xx = np.mgrid[:h, :w]
    disc = ((yy - h / 2) ** 2 + (xx - w / 3) ** 2 < (h / 4) ** 2).astype(np.float32)
    bar = ((xx > 3 * w // 4) & (yy > h // 4)).astype(np.float32)
    x = 0.2 * rng.random((b, h, w, 1)).astype(np.float32)
    x += (4.0 * disc + 2.0 * bar)[None, :, :, None]
    x[1] *= 0.3
    return x


def test_prewitt_matches_jax(rng):
    x = _images(rng) / 4.0
    want = np.asarray(jedges.prewitt_edges(jnp.asarray(x)))
    got = edges.prewitt_edges(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert 0 < float(want.max()) <= 1.0


@pytest.mark.parametrize("threshold", [2.0, 0.5])
def test_canny_matches_jax(rng, threshold, capsys):
    x = _images(rng)
    want = np.asarray(jedges.canny_edges(jnp.asarray(x), threshold))
    xt = torch.from_numpy(x)
    got = edges.canny_edges(xt, threshold).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    _, orient = edges.canny_orientation(xt)
    q = orient.numpy() / 45.0
    boundary = np.abs(q - np.floor(q) - 0.5) < 1e-4
    off = np.abs(got - want) > 1e-5
    assert not (off & ~boundary).any()
    assert off.sum() <= 0.005 * off.size
    with capsys.disabled():
        print(f"\ncanny threshold {threshold}: {int(off.sum())} of {off.size} pixels differ, "
              f"all on an orientation boundary ({int(boundary.sum())} such pixels)")
    assert (want > 0).any() and (want == 0).any()


def test_space_to_depth_layout_matches_jax(rng):
    x = rng.random((2, 8, 10, 3)).astype(np.float32)
    y = s2d.space_to_depth(torch.from_numpy(x))
    np.testing.assert_array_equal(y.numpy(), np.asarray(js2d.space_to_depth(jnp.asarray(x))))
    assert y.shape == (2, 4, 5, 12)
    np.testing.assert_array_equal(s2d.depth_to_space(y).numpy(), x)
    a = torch.from_numpy(rng.random((1, 6, 6, 3)).astype(np.float32))
    b = torch.from_numpy(rng.random((1, 6, 6, 2)).astype(np.float32))
    torch.testing.assert_close(s2d.space_to_depth(torch.cat([a, b], -1)),
                               torch.cat([s2d.space_to_depth(a), s2d.space_to_depth(b)], -1),
                               rtol=0, atol=0)


def _conv(x, w_hwio, stride, pads):
    """NHWC conv with an HWIO kernel and ((top, bottom), (left, right))."""
    xp = F.pad(x.permute(0, 3, 1, 2), (pads[1][0], pads[1][1], pads[0][0], pads[0][1]))
    return F.conv2d(xp, w_hwio.permute(3, 2, 0, 1), stride=stride).permute(0, 2, 3, 1)


@pytest.mark.parametrize("k", [3, 5])
@pytest.mark.parametrize("c,f", [(3, 16), (33, 32), (8, 1)])
def test_kernel_s2d_s2d(rng, k, c, f):
    x = torch.from_numpy(rng.standard_normal((2, 16, 16, c)).astype(np.float32))
    w = rng.standard_normal((k, k, c, f)).astype(np.float32)
    ws = s2d.kernel_s2d_s2d(torch.from_numpy(w))
    np.testing.assert_array_equal(ws.numpy(), np.asarray(js2d.kernel_s2d_s2d(jnp.asarray(w))))
    p = (k - 1) // 2
    want = _conv(x, torch.from_numpy(w), 1, ((p, p), (p, p)))
    got = s2d.depth_to_space(_conv(s2d.space_to_depth(x), ws, 1, ((1, 1), (1, 1))))
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * float(want.abs().max()))


@pytest.mark.parametrize("c,f", [(16, 32), (5, 7)])
def test_kernel_s2d_down(rng, c, f):
    x = torch.from_numpy(rng.standard_normal((2, 16, 16, c)).astype(np.float32))
    w = rng.standard_normal((3, 3, c, f)).astype(np.float32)
    wd = s2d.kernel_s2d_down(torch.from_numpy(w))
    np.testing.assert_array_equal(wd.numpy(), np.asarray(js2d.kernel_s2d_down(jnp.asarray(w))))
    want = _conv(x, torch.from_numpy(w), 2, ((1, 1), (1, 1)))
    got = _conv(s2d.space_to_depth(x), wd, 1, ((1, 0), (1, 0)))
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * float(want.abs().max()))


def test_bias_and_upsample_s2d(rng):
    b = rng.random(5).astype(np.float32)
    np.testing.assert_array_equal(s2d.bias_s2d(torch.from_numpy(b)).numpy(),
                                  np.asarray(js2d.bias_s2d(jnp.asarray(b))))
    z = rng.random((2, 4, 4, 3)).astype(np.float32)
    got = s2d.upsample2x_as_s2d(torch.from_numpy(z))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(js2d.upsample2x_as_s2d(jnp.asarray(z))))
    torch.testing.assert_close(s2d.depth_to_space(got), resize_nearest(torch.from_numpy(z), 8, 8),
                               rtol=0, atol=0)
