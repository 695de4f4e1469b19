"""Edge operators beyond Sobel: Prewitt and a differentiable Canny.

Counterpart of healthivert_tpu/ops/edges.py (parity with the reference's
models/edge_operator.py:51-245). They ship with the reference but are unused
by its training path (the EEM loss uses Sobel, ops/image.sobel_edges); they
are part of the component inventory. NHWC tensors, plain tensor ops on
whatever device the input is on.

The Canny is vectorized as in the JAX package: the reference's per-sample
gather loop (edge_operator.py:199-221) is one gather over the 8-direction
stack. Its constants are the JAX package's (180 / 3.14159, not pi), and
torch.round rounds half to even as jnp.round does; atan2 may differ from
XLA's by an ulp, which can move a pixel whose orientation sits on a 45
degree rounding boundary to the neighbouring direction.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .image import _edge_pad


def _shift_sum(xp, weights):
    """3x3 fixed filter via shifted adds on an edge-padded NHWC tensor."""
    h, w = xp.shape[1] - 2, xp.shape[2] - 2
    out = 0.0
    for dy in range(3):
        for dx in range(3):
            c = weights[dy][dx]
            if c:
                out = out + c * xp[:, dy:dy + h, dx:dx + w, :]
    return out


def prewitt_edges(x: torch.Tensor) -> torch.Tensor:
    """Prewitt gradient magnitude clipped to 1 (edge_operator.py:51-70)."""
    xp = _edge_pad(x)
    gx = _shift_sum(xp, [[-1, 0, 1], [-1, 0, 1], [-1, 0, 1]])
    gy = _shift_sum(xp, [[1, 1, 1], [0, 0, 0], [-1, -1, -1]])
    return torch.clamp(torch.sqrt(gx * gx + gy * gy), max=1.0)


def _gaussian_kernel(size=5, std=1.0):
    x = torch.arange(size, dtype=torch.float32) - (size - 1) / 2.0
    k = torch.exp(-0.5 * (x / std) ** 2)
    return (k / k.sum()).tolist()


# 8 directional neighbor offsets (dy, dx) in orientation order 0,45,...,315,
# matching the reference's hand-flipped filters (edge_operator.py:107-140):
# direction d compares against the neighbor the filter subtracts.
_DIRS = [(0, 1), (1, 1), (1, 0), (1, -1), (0, -1), (-1, -1), (-1, 0), (-1, 1)]


def canny_orientation(x: torch.Tensor):
    """The Canny's gradient magnitude and the orientation before its
    quantization to 45 degrees (degrees in [0, 360]) of (B, H, W, 1)
    images: 5 x 5 Gaussian blur (zero padding), Sobel gradients, the
    reference's 3-channel sum (gradients times 3)."""
    b, h, w, c = x.shape
    assert c == 1
    g = _gaussian_kernel()
    xpad = F.pad(x, (0, 0, 2, 2))
    xb = sum(g[i] * xpad[:, :, i:i + w, :] for i in range(5))
    xpad = F.pad(xb, (0, 0, 0, 0, 2, 2))
    xb = sum(g[i] * xpad[:, i:i + h, :, :] for i in range(5))

    xp = F.pad(xb, (0, 0, 1, 1, 1, 1))
    # reference sobel_filter: [[1,0,-1],[2,0,-2],[1,0,-1]] (x), transpose (y)
    gx = _shift_sum(xp, [[1, 0, -1], [2, 0, -2], [1, 0, -1]])
    gy = _shift_sum(xp, [[1, 2, 1], [0, 0, 0], [-1, -2, -1]])
    # reference replicates grayscale to RGB and sums three identical mags
    grad_mag = 3.0 * torch.sqrt(gx * gx + gy * gy)
    orient = torch.atan2(3.0 * gy, 3.0 * gx) * (180.0 / 3.14159) + 180.0
    return grad_mag, orient


def canny_edges(x: torch.Tensor, threshold: float = 2.0) -> torch.Tensor:
    """Differentiable Canny on (B, H, W, 1) images: `canny_orientation`,
    the orientation quantized to 45 degrees, non-max suppression against
    both directional neighbours, threshold, clamp to 1
    (edge_operator.py:147-245)."""
    b, h, w, _ = x.shape
    grad_mag, orient = canny_orientation(x)
    d_pos = torch.remainder(torch.round(orient / 45.0), 8).to(torch.int64)
    d_neg = (d_pos + 4) % 8

    mp = F.pad(grad_mag, (0, 0, 1, 1, 1, 1))
    neigh = torch.stack(
        [mp[:, 1 + dy:1 + dy + h, 1 + dx:1 + dx + w, :] for dy, dx in _DIRS], dim=-1
    )  # (B, H, W, 1, 8): directional differences grad - neighbor
    diffs = grad_mag[..., None] - neigh
    pos = torch.gather(diffs, -1, d_pos[..., None])[..., 0]
    neg = torch.gather(diffs, -1, d_neg[..., None])[..., 0]
    is_max = torch.minimum(pos, neg) > 0.0

    thin = torch.where(is_max, grad_mag, torch.zeros_like(grad_mag))
    thin = torch.where(thin < threshold, torch.zeros_like(thin), thin)
    return torch.clamp(thin, max=1.0)
