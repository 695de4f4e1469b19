"""The exact int8 convolution of the int8 inference mode.

The JAX package computes its int8 conv with XLA, outside any Pallas kernel
(healthivert_tpu/models/layers.py:179-187: `lax.conv_general_dilated` on
int8 operands with `preferred_element_type=int32`). PyTorch has no int8
`F.conv2d` for CUDA tensors, so on the card the product is an im2col of
int8 views times the weight, in `torch._int_mm` (cuBLASLt's s8 GEMM with
int32 sums):

- the activation, channels last, is zero-padded once; the k x k strided and
  dilated slices of the padded copy are written side by side into one int8
  matrix (M, Kp), one row an output pixel, K = k * k * C columns in
  (kh, kw, c) order, by a single strided copy through an `as_strided` view
  (in the widest integer type whose width divides C, so that a 16-channel
  row moves as two int64 words);
- `_int_mm` needs K and N multiples of 8 and M above 16: the matrix's
  columns K..Kp and the weight's rows past O are zeros, which change no sum,
  and a tiny M is padded with zero rows that are dropped;
- batches whose matrix passes `IM2COL_BYTES` run in chunks of samples, each
  into its rows of one int32 output.

Every product of two int8 values is summed exactly in int32 (a 3 x 3 x 128
conv sums at most 1152 * 127^2 < 2^31), so the result equals the plain
version `int8_conv2d_reference` bit for bit, on any device. No kernel is
written here by hand: a product that the JAX package leaves to XLA may stay
a library call. A hand-written s8 implicit-GEMM conv (no im2col in HBM) is
queued in ROADMAP.md as later work.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# the largest im2col matrix built at once; larger batches run in chunks
IM2COL_BYTES = 1 << 30
_MIN_M = 17  # torch._int_mm on CUDA takes more than 16 rows


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def out_size(n: int, k: int, stride: int, padding: int, dilation: int) -> int:
    return (n + 2 * padding - dilation * (k - 1) - 1) // stride + 1


def int8_conv2d_reference(qx: torch.Tensor, qw: torch.Tensor, stride: int = 1,
                          padding: int = 0, dilation: int = 1) -> torch.Tensor:
    """Plain version: the conv of the integer values in float64, exact (every
    sum stays far below 2^53), rounded (an FFT or Winograd algorithm may
    leave an error far below 0.5) and cast to int32. qx (B, C, H, W) and qw
    (O, C, k, k) int8; returns (B, O, H', W') int32."""
    y = F.conv2d(qx.double(), qw.double(), None, stride, padding, dilation)
    return y.round().to(torch.int32)


def _wide(t: torch.Tensor, c: int) -> torch.Tensor:
    """View the last (channel) dim of an int8 tensor as the widest integer
    type whose width divides c."""
    for dt, w in ((torch.int64, 8), (torch.int32, 4), (torch.int16, 2)):
        if c % w == 0:
            return t.view(dt)
    return t


def im2col(qx: torch.Tensor, k: int, stride: int, padding: int, dilation: int,
           kp: int) -> torch.Tensor:
    """(B * H' * W', kp) int8 patch matrix of qx (B, C, H, W): row
    (b, oh, ow), column (i * k + j) * C + c holds
    qx[b, c, oh * stride + i * dilation - padding, ow * stride + j * dilation - padding]
    (zero outside the image); columns k * k * C .. kp are zero."""
    b, c, h, w = qx.shape
    ho, wo = out_size(h, k, stride, padding, dilation), out_size(w, k, stride, padding, dilation)
    xp = qx.new_zeros((b, h + 2 * padding, w + 2 * padding, c))
    xp[:, padding:padding + h, padding:padding + w] = qx.permute(0, 2, 3, 1)
    a = qx.new_empty((b * ho * wo, kp))
    kk = k * k * c
    if kp > kk:
        a[:, kk:] = 0
    src, dst = _wide(xp, c), _wide(a, c)
    u = c * xp.element_size() // src.element_size()  # channels in wide words
    hp, wp = xp.shape[1], xp.shape[2]
    rs = dst.shape[1]  # a row in wide words
    taps = src.as_strided((b, ho, wo, k, k, u),
                          (hp * wp * u, stride * wp * u, stride * u,
                           dilation * wp * u, dilation * u, 1))
    dst.as_strided((b, ho, wo, k, k, u), (ho * wo * rs, wo * rs, rs, k * u, u, 1)).copy_(taps)
    return a


def weight_matrix(qw: torch.Tensor, kp: int, np_: int) -> torch.Tensor:
    """(kp, np_) column-major int8 weight of qw (O, C, k, k), rows in the
    im2col's (kh, kw, c) order, zero past K and past O."""
    o, c, k, _ = qw.shape
    w = qw.new_zeros((np_, kp))
    w[:o, :k * k * c] = qw.permute(0, 2, 3, 1).reshape(o, k * k * c)
    return w.t()


def int8_conv2d_im2col(qx: torch.Tensor, qw: torch.Tensor, stride: int = 1,
                       padding: int = 0, dilation: int = 1) -> torch.Tensor:
    """The card route: im2col of int8 views, then `torch._int_mm`. It runs
    on any device whose `_int_mm` does (the CPU tests call it directly).
    Returns (B, O, H', W') int32 with channels-last strides."""
    b, c, h, w = qx.shape
    o, _, k, _ = qw.shape
    ho, wo = out_size(h, k, stride, padding, dilation), out_size(w, k, stride, padding, dilation)
    kp, np_ = _round_up(k * k * c, 8), _round_up(o, 8)
    wmat = weight_matrix(qw, kp, np_)
    per_sample = ho * wo
    nb = max(1, min(b, IM2COL_BYTES // max(1, per_sample * kp)))
    m_pad = max(0, _MIN_M - b * per_sample)
    out = torch.empty((b * per_sample + m_pad, np_), dtype=torch.int32, device=qx.device)
    for b0 in range(0, b, nb):
        a = im2col(qx[b0:b0 + nb], k, stride, padding, dilation, kp)
        if m_pad:
            a = torch.cat([a, a.new_zeros((m_pad, kp))])
        r0 = b0 * per_sample
        torch._int_mm(a, wmat, out=out[r0:r0 + a.shape[0]])
    y = out[:b * per_sample].view(b, ho, wo, np_)[..., :o]
    return y.permute(0, 3, 1, 2)


def int8_conv2d(qx: torch.Tensor, qw: torch.Tensor, stride: int = 1, padding: int = 0,
                dilation: int = 1) -> torch.Tensor:
    """int8 x int8 -> int32 conv, NCHW activations, OIHW weights. On a CUDA
    tensor it runs the card route (counted in `int8_conv2d.launches`, one per
    call) or raises; on a CPU tensor the plain version."""
    if qx.dtype != torch.int8 or qw.dtype != torch.int8:
        raise TypeError(f"int8_conv2d takes int8 operands, got {qx.dtype} and {qw.dtype}")
    if qx.dim() != 4 or qw.dim() != 4 or qw.shape[1] != qx.shape[1] or qw.shape[2] != qw.shape[3]:
        raise ValueError(f"int8_conv2d: activations {tuple(qx.shape)}, weights {tuple(qw.shape)}")
    if qx.device != qw.device:
        raise ValueError(f"int8_conv2d: operands on {qx.device} and {qw.device}")
    if qx.device.type == "cuda":
        int8_conv2d.launches += 1
        return int8_conv2d_im2col(qx, qw, stride, padding, dilation)
    if qx.device.type == "cpu":
        return int8_conv2d_reference(qx, qw, stride, padding, dilation)
    raise ValueError(f"int8_conv2d: no route for {qx.device}")


int8_conv2d.launches = 0  # card-route convolutions in this process
