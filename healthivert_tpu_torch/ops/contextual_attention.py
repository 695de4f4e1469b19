"""Batched contextual attention (patch-match inpainting attention).

Counterpart of healthivert_tpu/ops/contextual_attention.py:52-251, with the
generator's fixed settings (3x3 matching patches at stride 1, rate 2, the
two 3x3 fuse passes, softmax scale 10):

  similarity:  3x3 patches of the downscaled foreground against the
               norm-scaled 3x3 patches of the downscaled background
  fuse:        the 3x3 identity-kernel conv over the (L, P) score image as
               diagonal shifted adds, and again in the transposed flatten
  softmax:     gated by the patch-availability mask, over the L patch axis
  paste:       probs against the 4x4 stride-2 raw background patches, then
               the overlap-add of the stride-2 transposed conv, / 4

Each sample is gated with its own mask, as in the JAX package (the torch
original used sample 0's mask for the whole batch). The pipeline from
scores to paste runs in `attention_cuda.attention_v2`: the CUDA kernel for
a tensor on the card, its plain PyTorch version for a tensor on the CPU.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from .image import resize_nearest


class AttentionOut(NamedTuple):
    y: torch.Tensor  # (B, H, W, C) pasted features
    offsets: torch.Tensor  # (B, H/2, W/2, 2) int32 argmax patch coords (h, w)


def _same_pad_hw(x, k, s):
    """Symmetric SAME padding of H and W of an NHWC tensor."""
    h, w = x.shape[1], x.shape[2]
    oh, ow = -(-h // s), -(-w // s)
    ph = max(0, (oh - 1) * s + k - h)
    pw = max(0, (ow - 1) * s + k - w)
    return F.pad(x, (0, 0, pw // 2, pw - pw // 2, ph // 2, ph - ph // 2))


def extract_patches(x, k, s):
    """(B, H, W, C) -> (B, L, k, k, C) patches with SAME padding, row-major
    over the output grid, (ky, kx, c) inside a patch."""
    xp = _same_pad_hw(x, k, s)
    b, c = x.shape[0], x.shape[3]
    oh, ow = -(-x.shape[1] // s), -(-x.shape[2] // s)
    cols = [
        xp[:, dy : dy + (oh - 1) * s + 1 : s, dx : dx + (ow - 1) * s + 1 : s, :]
        for dy in range(k)
        for dx in range(k)
    ]
    return torch.cat(cols, dim=-1).reshape(b, oh * ow, k, k, c)


def _fuse_diag(y):
    """3x3 identity-kernel conv over (B, N, M) read as an image:
    out[i, j] = y[i-1, j-1] + y[i, j] + y[i+1, j+1], zero-padded."""
    yp = F.pad(y, (1, 1, 1, 1))
    return yp[:, :-2, :-2] + yp[:, 1:-1, 1:-1] + yp[:, 2:, 2:]


def _perm(x, n, axis, direction):
    """Gather x[sigma(i)] along `axis`, where sigma steps +-1 in the
    transposed flatten of the (L/n, n) grid; the invalid end is zero."""
    m = x.shape[axis]
    z = torch.zeros_like(x.narrow(axis, 0, 1))
    if direction > 0:
        return torch.cat([x.narrow(axis, n, m - n), x.narrow(axis, 1, n - 1), z], axis)
    return torch.cat([z, x.narrow(axis, m - n, n - 1), x.narrow(axis, 0, m - n)], axis)


def fuse_scores(s, wd):
    """Both fuse passes over the (B, L, P) scores of a (., wd) grid."""
    s = _fuse_diag(s)
    return (
        s
        + _perm(_perm(s, wd, 1, +1), wd, 2, +1)
        + _perm(_perm(s, wd, 1, -1), wd, 2, -1)
    )


def fuse_adjoint(g, wd):
    """Transpose of `fuse_scores`: the two passes in the other order, each
    being its own adjoint (it holds both +-1 shifts, and sigma- inverts
    sigma+)."""
    g = g + _perm(_perm(g, wd, 1, +1), wd, 2, +1) + _perm(_perm(g, wd, 1, -1), wd, 2, -1)
    return _fuse_diag(g)


def patches_adjoint(dpat, h, w, c, k):
    """Adjoint of the stride-1 SAME `extract_patches` with odd k: overlap-add
    of the k*k shifted planes of (B, h*w, k*k*c) patch gradients."""
    b = dpat.shape[0]
    d = dpat.reshape(b, h, w, k, k, c)
    pad = (k - 1) // 2
    out = dpat.new_zeros((b, h + 2 * pad, w + 2 * pad, c))
    for dy in range(k):
        for dx in range(k):
            out[:, dy : dy + h, dx : dx + w, :] += d[:, :, :, dy, dx, :]
    return out[:, pad : pad + h, pad : pad + w, :]


def _fold_overlap_add(vals, h, w, s, k):
    """Overlap-add of (B, hd, wd, k, k, C) patch values on a stride-s grid
    with padding 1 (conv_transpose2d(stride=s, padding=1)), divided by 4."""
    bs, hd, wd, _, _, c = vals.shape
    out = vals.new_zeros((bs, h + 2, w + 2, c))
    for dy in range(k):
        for dx in range(k):
            out[:, dy : dy + (hd - 1) * s + 1 : s, dx : dx + (wd - 1) * s + 1 : s, :] += (
                vals[:, :, :, dy, dx, :]
            )
    return out[:, 1 : 1 + h, 1 : 1 + w, :] / 4.0


def contextual_attention(f, b, mask, softmax_scale: float = 10.0,
                         compute_offsets: bool = False) -> AttentionOut:
    """f, b: (B, H, W, C) NHWC features (foreground to fill, background to
    borrow from; the generator passes f == b). mask: (B, 4H, 4W, 1), 1 in
    the hole, downscaled here by 1/8 to the H/2 x W/2 matching grid.

    compute_offsets: also return the argmax patch coordinates per query,
    taken from the attention's `probs` residual. When autograd records
    (grad enabled and f or b requiring grad) the attention runs through
    `AttentionV2Function`, whose backward is the backward kernel, with or
    without offsets (the offsets read the probs it saved, and y keeps its
    gradient, as the JAX package's XLA formulation does); under no_grad it
    is a plain call."""
    from .attention_cuda import AttentionV2Function, attention_v2

    bs, h, w, _ = f.shape
    hd, wd = h // 2, w // 2
    fd = resize_nearest(f, hd, wd)
    bd = resize_nearest(b, hd, wd)

    # patch-availability gate: 1 where the 3x3 mask patch holds no hole
    md = resize_nearest(mask, mask.shape[1] // 8, mask.shape[2] // 8)
    mpat = extract_patches(md, 3, 1)
    mm = (mpat.mean(dim=(2, 3, 4)) == 0.0).to(torch.float32)  # (B, L)

    args = (fd.contiguous(), bd.contiguous(), b.contiguous(), mm, hd, wd, softmax_scale)
    records = torch.is_grad_enabled() and (f.requires_grad or b.requires_grad)
    if compute_offsets:
        if records:
            y, probs = AttentionV2Function.apply(*args, True)
        else:
            y, _s, probs, _n = attention_v2(*args, emit_residuals=True)
        off = torch.argmax(probs, dim=1)  # (B, P)
        offsets = torch.stack([off // wd, off % wd], dim=-1)
        offsets = offsets.reshape(bs, hd, wd, 2).to(torch.int32)
    else:
        y = AttentionV2Function.apply(*args) if records else attention_v2(*args)
        offsets = torch.zeros((bs, hd, wd, 2), dtype=torch.int32, device=f.device)
    return AttentionOut(y.to(f.dtype), offsets)
