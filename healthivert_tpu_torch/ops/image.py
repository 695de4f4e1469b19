"""Image ops: nearest resize, Sobel edge magnitude and the soft Dice of the
training losses.

Counterpart of healthivert_tpu/ops/image.py (`resize_nearest` :158,
`sobel_edges` :33, `dice_coeff` :52). Tensors are NHWC, as there.
"""

from __future__ import annotations

import torch


def _edge_pad(x: torch.Tensor) -> torch.Tensor:
    """Replication-pad H and W of an NHWC tensor by 1."""
    h, w = x.shape[1], x.shape[2]
    rows = torch.arange(-1, h + 1, device=x.device).clamp(0, h - 1)
    cols = torch.arange(-1, w + 1, device=x.device).clamp(0, w - 1)
    return x.index_select(1, rows).index_select(2, cols)


def sobel_edges(x: torch.Tensor) -> torch.Tensor:
    """Sobel gradient magnitude clipped to 1: replicate-pad, the two fixed
    3x3 filters as shifted adds, sqrt(gx^2 + gy^2), min with 1.

    x: (B, H, W, 1) in [0, 1]. Returns (B, H, W, 1) in x's dtype."""
    xp = _edge_pad(x)
    tl, tc, tr = xp[:, :-2, :-2], xp[:, :-2, 1:-1], xp[:, :-2, 2:]
    ml, mr = xp[:, 1:-1, :-2], xp[:, 1:-1, 2:]
    bl, bc, br = xp[:, 2:, :-2], xp[:, 2:, 1:-1], xp[:, 2:, 2:]
    gx = (tr - tl) + 2.0 * (mr - ml) + (br - bl)
    gy = (tl + 2.0 * tc + tr) - (bl + 2.0 * bc + br)
    mag = torch.sqrt(gx * gx + gy * gy)
    return torch.clamp(mag, max=1.0)


def resize_nearest(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Nearest-neighbour resize of an NHWC tensor with the rule
    src = floor(dst * in / out) (torch F.interpolate(mode="nearest")).

    Integer up-factors repeat pixels, integer down-factors take a strided
    view; other ratios gather."""
    b, h, w, c = x.shape
    if out_h % h == 0 and out_w % w == 0:
        rh, rw = out_h // h, out_w // w
        if (rh, rw) == (1, 1):
            return x
        y = x[:, :, None, :, None, :].expand(b, h, rh, w, rw, c)
        return y.reshape(b, out_h, out_w, c)
    if h % out_h == 0 and w % out_w == 0:
        return x[:, :: h // out_h, :: w // out_w, :]
    ih = torch.arange(out_h, device=x.device) * h // out_h
    iw = torch.arange(out_w, device=x.device) * w // out_w
    return x.index_select(1, ih).index_select(2, iw)


def dice_coeff(pred: torch.Tensor, gt: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Soft Dice, averaged over the batch: (2 tp + eps) / (sum(pred) +
    sum(gt) + eps) per sample (the reference's diceCoeff(activation='none'))."""
    n = pred.shape[0]
    p = pred.reshape(n, -1)
    g = gt.reshape(n, -1)
    tp = torch.sum(g * p, dim=1)
    return torch.mean((2.0 * tp + eps) / (p.sum(dim=1) + g.sum(dim=1) + eps))
