"""SHRM paste-back, the band crop of the local discriminator's input and the
centre-column mask.

Counterpart of healthivert_tpu/ops/geometry.py (`shrm_paste` and
`shrm_paste_batch` :68-106, `band_crop`/`band_crop_batch` :109-135,
`local_crop_mask` :138). Row ranges are index masks and gathers, so the
batched forms run without a per-sample loop or a host sync.
"""

from __future__ import annotations

import torch


def shrm_paste_batch(fake_raw, real, pred_h, real_height, x1, x2):
    """Reassemble full slices from the synthesized band and the real context
    rows, for a batch.

    The predicted height h = max(ceil(pred_h), real_height) widens the band
    symmetrically around the vertebra; rows above it come from
    real[r + (h - real_height) // 2], rows below from real[x2 + r - x_bottom].

    fake_raw, real: (B, H, W) or (B, H, W, C); pred_h (B,) in rows;
    real_height, x1, x2: (B,) integers with real_height = x2 - x1."""
    bsz, h = fake_raw.shape[0], fake_raw.shape[1]
    col = lambda v: v.reshape(bsz, 1).long()
    real_height, x1, x2 = col(real_height), col(x1), col(x2)
    height = torch.maximum(torch.ceil(pred_h.reshape(bsz, 1)).long(), real_height)
    hd2 = torch.div(height - real_height, 2, rounding_mode="floor")
    x_upper = x1 - hd2
    x_bottom = x_upper + height

    r = torch.arange(h, device=fake_raw.device).reshape(1, h)
    upper = r < x_upper
    lower = r >= x_bottom
    mid = ~(upper | lower)
    idx = torch.where(upper, r + hd2, torch.where(lower, x2 + r - x_bottom, 0))
    idx = idx.clamp(0, h - 1)
    trail = (1,) * (fake_raw.dim() - 2)
    real_rows = torch.gather(
        real, 1, idx.reshape((bsz, h) + trail).expand(real.shape)
    )
    midk = mid.reshape((bsz, h) + trail)
    ctxk = (upper | lower).reshape((bsz, h) + trail)
    return torch.where(midk, fake_raw, 0) + torch.where(ctxk, real_rows, 0)


def shrm_paste(fake_raw, real, pred_h, real_height, x1, x2):
    """One slice of `shrm_paste_batch`: fake_raw/real (H, W) or (H, W, C),
    the other arguments scalars or 0-d tensors."""
    t = lambda v: torch.as_tensor(v, device=fake_raw.device).reshape(1)
    return shrm_paste_batch(
        fake_raw[None], real[None], t(pred_h).float(), t(real_height),
        t(x1), t(x2),
    )[0]


def band_crop_batch(img: torch.Tensor, mask: torch.Tensor, rows: int = 48,
                    cols: int = 128) -> torch.Tensor:
    """Static-shape (rows, cols) crop of each sample of `img` that holds the
    whole support of mask * img * local_crop_mask: the local
    discriminator's input. The row start follows the first row where the
    sample's mask is non-zero (less a margin of 3, clamped to the image; 0
    for an empty mask), the columns are the centred window.

    img, mask: (B, H, W, C). The rows are gathered by an index tensor on the
    device, so the crop is differentiable in img and needs no host sync."""
    b, h, w = img.shape[0], img.shape[1], img.shape[2]
    row_any = (mask > 0).flatten(2).any(dim=2)  # (B, H)
    r = torch.arange(h, device=img.device)
    first = torch.where(row_any, r, h).amin(dim=1)
    first = torch.where(first == h, 0, first)  # an empty mask crops from row 0
    r0 = torch.clamp(first - 3, 0, h - rows)
    idx = r0[:, None] + torch.arange(rows, device=img.device)[None, :]  # (B, rows)
    c0 = (w - cols) // 2
    band = img[:, :, c0 : c0 + cols]
    gather = idx.reshape(b, rows, 1, 1).expand(b, rows, cols, img.shape[3])
    return torch.gather(band, 1, gather)


def band_crop(img: torch.Tensor, mask: torch.Tensor, rows: int = 48,
              cols: int = 128) -> torch.Tensor:
    """One slice of `band_crop_batch`: img, mask (H, W, C)."""
    return band_crop_batch(img[None], mask[None], rows, cols)[0]


def local_crop_mask(height_rows: int, width: int, half_width: int = 35,
                    device="cpu") -> torch.Tensor:
    """(H, W) float32 mask of the centre columns [W//2 - 35, W//2 + 35)."""
    c = torch.arange(width, device=device)[None, :]
    center = width // 2
    m = ((c >= center - half_width) & (c < center + half_width)).float()
    return m * torch.ones((height_rows, 1), device=device)
