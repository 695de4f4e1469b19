"""Image ops: nearest resize, Sobel edge magnitude, the soft Dice of the
training losses, and the evaluation metrics (hard Dice and IoU, PSNR, SSIM).

Counterpart of healthivert_tpu/ops/image.py (`resize_nearest` :158,
`sobel_edges` :33, `dice_coeff` :52, the metrics :67-156). Tensors are
NHWC, as there; the metrics take (H, W) images, or (N, H, W) stacks with
one data range per image.
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


def dice_score(pred: torch.Tensor, target: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Hard Dice over flattened binary masks (train.py:37-41)."""
    inter = torch.sum(pred * target)
    return (2.0 * inter + eps) / (torch.sum(pred) + torch.sum(target) + eps)


def iou_score(pred: torch.Tensor, target: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Hard IoU over flattened binary masks (train.py:43-48)."""
    inter = torch.sum(pred * target)
    union = torch.sum(pred) + torch.sum(target) - inter
    return (inter + eps) / (union + eps)


def psnr(a: torch.Tensor, b: torch.Tensor, data_range=1.0) -> torch.Tensor:
    """Peak SNR, matching skimage.metrics.peak_signal_noise_ratio; over the
    last two axes, so (N, H, W) stacks give (N,) with data_range (N,)."""
    mse = torch.mean((a.float() - b.float()) ** 2, dim=(-2, -1))
    dr = torch.as_tensor(data_range, dtype=torch.float32, device=mse.device)
    return 10.0 * torch.log10((dr * dr) / torch.clamp(mse, min=1e-12))


def _uniform_filter(x: torch.Tensor, size: int) -> torch.Tensor:
    """Mean filter with a size x size window, VALID, over the last two axes:
    separable shift-and-add, the JAX package's order of float32 adds."""
    h, w = x.shape[-2:]
    y = sum(x[..., d : h - size + 1 + d, :] for d in range(size))
    y = sum(y[..., :, d : w - size + 1 + d] for d in range(size))
    return y / (size * size)


def ssim(a: torch.Tensor, b: torch.Tensor, data_range=1.0, win_size: int = 7) -> torch.Tensor:
    """Structural similarity of 2D images over the last two axes.

    Matches skimage.metrics.structural_similarity defaults: uniform 7x7
    window, K1=0.01, K2=0.03, sample covariance normalization (N/(N-1)),
    mean over the valid (cropped) region. (N, H, W) stacks give (N,) with
    data_range (N,)."""
    a = a.float()
    b = b.float()
    k1, k2 = 0.01, 0.03
    nw = win_size * win_size
    cov_norm = nw / (nw - 1.0)

    ux = _uniform_filter(a, win_size)
    uy = _uniform_filter(b, win_size)
    uxx = _uniform_filter(a * a, win_size)
    uyy = _uniform_filter(b * b, win_size)
    uxy = _uniform_filter(a * b, win_size)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)

    dr = torch.as_tensor(data_range, dtype=torch.float32, device=a.device)
    dr = dr.reshape(dr.shape + (1, 1))
    c1 = (k1 * dr) ** 2
    c2 = (k2 * dr) ** 2
    num = (2.0 * ux * uy + c1) * (2.0 * vxy + c2)
    den = (ux * ux + uy * uy + c1) * (vx + vy + c2)
    return torch.mean(num / den, dim=(-2, -1))


def psnr_ssim_batch(a: torch.Tensor, b: torch.Tensor, data_range: torch.Tensor,
                    win_size: int = 7, with_ssim: bool = True) -> tuple:
    """Per-slice PSNR and SSIM over a stack of 2D images: a, b (N, H, W),
    data_range (N,). Returns ((N,) psnr, (N,) ssim), the SSIM half None when
    with_ssim=False (images smaller than the window)."""
    p = psnr(a, b, data_range)
    if not with_ssim:
        return p, None
    return p, ssim(a, b, data_range, win_size=win_size)
