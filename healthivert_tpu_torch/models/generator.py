"""Two-stage coarse-to-refine inpainting generator with SHRM height heads and
CAM injection.

Counterpart of healthivert_tpu/models/generator.py:25-206, layer for layer,
with the same module names so that the flax parameter trees map onto this
state dict one to one (utils/weights.py). Inputs and outputs are NHWC, as
in the JAX package; inside, the convs run NCHW on channels-last memory.

Inputs are (B, H, W, 1) in [-1, 1]; mask and CAM in [0, 1]; slice_ratio (B,).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn as nn

from ..ops.contextual_attention import contextual_attention
from ..ops.image import resize_nearest
from .layers import Conv2dBlock, SNConv, _l2, lecun_normal_


class GeneratorOut(NamedTuple):
    coarse_seg: torch.Tensor  # (B, H, W, 1) sigmoid
    fine_seg: torch.Tensor  # (B, H, W, 1) sigmoid
    x_stage1: torch.Tensor  # (B, H, W, 1) clamped [-1, 1]
    x_stage2: torch.Tensor  # (B, H, W, 1) clamped [-1, 1]
    offsets: torch.Tensor  # (B, H/8, W/8, 2) attention argmax coords
    pred1_h: torch.Tensor  # (B,) sigmoid height fraction (coarse), float32
    pred2_h: torch.Tensor  # (B,) sigmoid height fraction (fine), float32


def _bc_ratio(slice_ratio, h, w, dtype=torch.float32):
    """(B,) -> (B, H, W, 1) constant plane.

    dtype must follow the image input: a float32 plane concatenated with
    bfloat16 features would promote the whole trunk to float32."""
    b = slice_ratio.shape[0]
    return slice_ratio.reshape(b, 1, 1, 1).to(dtype).expand(b, h, w, 1)


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def _resize(z, out_h, out_w):
    """Nearest resize of an NCHW tensor (through the NHWC op)."""
    return _nchw(resize_nearest(_nhwc(z), out_h, out_w))


_ATROUS = (("conv7_atrous", 2), ("conv8_atrous", 4), ("conv9_atrous", 8),
           ("conv10_atrous", 16))


class _Stack(nn.Module):
    """Holds named Conv2dBlocks; `blk(in, out, k, s, p, r, act)` adds one."""

    def __init__(self, dtype):
        super().__init__()
        self.dtype = dtype

    def blk(self, name, fin, fout, k, s, p, r=1, act="elu"):
        self.add_module(name, Conv2dBlock(fin, fout, k, s, p, r, act, dtype=self.dtype))


class CoarseGenerator(_Stack):
    """Encoder -> atrous trunk (+ SHRM head) -> decoder with CAM injection
    at H/2 (conv20) and H (conv19) -> CT head (clamp) and seg head (sigmoid)."""

    def __init__(self, cnum=16, dtype=None):
        super().__init__(dtype)
        c = cnum
        self.blk("conv1", 3, c, 5, 1, 2)
        self.blk("conv2_downsample", c, c * 2, 3, 2, 1)
        self.blk("conv3", c * 2, c * 2, 3, 1, 1)
        self.blk("conv4_downsample", c * 2, c * 4, 3, 2, 1)
        self.blk("conv5", c * 4, c * 4, 3, 1, 1)
        self.blk("conv6", c * 4, c * 4, 3, 1, 1)
        for name, r in _ATROUS:
            self.blk(name, c * 4, c * 4, 3, 1, r, r)
        self.fc_height = nn.Linear(c * 4, 1)
        self.blk("conv11", c * 4, c * 4, 3, 1, 1)
        self.blk("conv12", c * 4, c * 4, 3, 1, 1)
        self.blk("conv20", c * 4 + 1, c * 4, 3, 1, 1)
        self.blk("conv13", c * 4, c * 2, 3, 1, 1)
        self.blk("conv14", c * 2, c * 2, 3, 1, 1)
        self.blk("conv19", c * 2 + 1, c * 2, 3, 1, 1)
        self.blk("conv15", c * 2, c, 3, 1, 1)
        self.blk("conv16", c, c // 2, 3, 1, 1)
        self.blk("conv17", c // 2, 1, 3, 1, 1, act="none")
        self.blk("conv18", c // 2, 1, 3, 1, 1, act="sigmoid")

    def forward(self, x, mask, cam, slice_ratio):
        h, w = x.shape[1], x.shape[2]
        z = _nchw(torch.cat([x, _bc_ratio(slice_ratio, h, w, x.dtype), mask], dim=-1))
        for name in ("conv1", "conv2_downsample", "conv3", "conv4_downsample",
                     "conv5", "conv6", "conv7_atrous", "conv8_atrous",
                     "conv9_atrous", "conv10_atrous"):
            z = getattr(self, name)(z)
        pooled = z.mean(dim=(2, 3))
        pred1_h = torch.sigmoid(self.fc_height(pooled.float()))[:, 0]
        z = self.conv12(self.conv11(z))
        z = _resize(z, h // 2, w // 2)
        cam_half = _nchw(resize_nearest(cam, h // 2, w // 2))
        z = self.conv20(torch.cat([z, cam_half], dim=1))
        z = self.conv14(self.conv13(z))
        z = _resize(z, h, w)
        z = self.conv19(torch.cat([z, _nchw(cam)], dim=1))
        z = self.conv16(self.conv15(z))
        x_stage1 = torch.clamp(self.conv17(z), -1.0, 1.0)
        coarse_seg = self.conv18(z)
        return _nhwc(coarse_seg), _nhwc(x_stage1), pred1_h


class FineGenerator(_Stack):
    """Dilated hallucination branch + contextual-attention branch, merged;
    the merged trunk carries the second SHRM head, and the stage-1 CT joins
    right before the two output heads."""

    def __init__(self, cnum=16, dtype=None, compute_offsets=False):
        super().__init__(dtype)
        c = cnum
        self.compute_offsets = compute_offsets
        self.blk("conv1", 4, c, 5, 1, 2)
        self.blk("conv2_downsample", c, c, 3, 2, 1)
        self.blk("conv3", c, c * 2, 3, 1, 1)
        self.blk("conv4_downsample", c * 2, c * 2, 3, 2, 1)
        self.blk("conv5", c * 2, c * 4, 3, 1, 1)
        self.blk("conv6", c * 4, c * 4, 3, 1, 1)
        for name, r in _ATROUS:
            self.blk(name, c * 4, c * 4, 3, 1, r, r)
        self.blk("pmconv1", 4, c, 5, 1, 2)
        self.blk("pmconv2_downsample", c, c, 3, 2, 1)
        self.blk("pmconv3", c, c * 2, 3, 1, 1)
        self.blk("pmconv4_downsample", c * 2, c * 4, 3, 2, 1)
        self.blk("pmconv5", c * 4, c * 4, 3, 1, 1)
        self.blk("pmconv6", c * 4, c * 4, 3, 1, 1, act="relu")
        self.blk("pmconv9", c * 4, c * 4, 3, 1, 1)
        self.blk("pmconv10", c * 4, c * 4, 3, 1, 1)
        self.blk("allconv11", c * 8, c * 4, 3, 1, 1)
        self.fc_height = nn.Linear(c * 4, 1)
        self.blk("allconv12", c * 4, c * 4, 3, 1, 1)
        self.blk("allconv19", c * 4, c * 4, 3, 1, 1)
        self.blk("allconv13", c * 4, c * 2, 3, 1, 1)
        self.blk("allconv14", c * 2, c * 2, 3, 1, 1)
        self.blk("allconv15", c * 2, c, 3, 1, 1)
        self.blk("allconv16", c, c // 2, 3, 1, 1)
        self.blk("allconv17", c // 2 + 1, 1, 3, 1, 1, act="none")
        self.blk("allconv18", c // 2 + 1, 1, 3, 1, 1, act="sigmoid")

    def forward(self, xin, x_stage1, mask, coarse_seg, slice_ratio):
        h, w = xin.shape[1], xin.shape[2]
        xnow = _nchw(torch.cat(
            [xin, coarse_seg, mask, _bc_ratio(slice_ratio, h, w, xin.dtype)], dim=-1
        ))

        z = xnow
        for name in ("conv1", "conv2_downsample", "conv3", "conv4_downsample",
                     "conv5", "conv6", "conv7_atrous", "conv8_atrous",
                     "conv9_atrous", "conv10_atrous"):
            z = getattr(self, name)(z)
        x_hallu = z

        a = xnow
        for name in ("pmconv1", "pmconv2_downsample", "pmconv3",
                     "pmconv4_downsample", "pmconv5", "pmconv6"):
            a = getattr(self, name)(a)
        a_nhwc = _nhwc(a)
        att = contextual_attention(
            a_nhwc, a_nhwc, mask, softmax_scale=10.0,
            compute_offsets=self.compute_offsets,
        )
        pm = self.pmconv10(self.pmconv9(_nchw(att.y)))

        z = self.allconv11(torch.cat([x_hallu, pm], dim=1))
        pooled = z.mean(dim=(2, 3))
        pred2_h = torch.sigmoid(self.fc_height(pooled.float()))[:, 0]

        z = self.allconv19(self.allconv12(z))
        z = _resize(z, h // 2, w // 2)
        z = self.allconv14(self.allconv13(z))
        z = _resize(z, h, w)
        z = self.allconv16(self.allconv15(z))
        z = torch.cat([z, _nchw(x_stage1)], dim=1)
        x_stage2 = torch.clamp(self.allconv17(z), -1.0, 1.0)
        fine_seg = self.allconv18(z)
        return _nhwc(fine_seg), _nhwc(x_stage2), att.offsets, pred2_h


class Generator(nn.Module):
    """Full two-stage generator.

    dtype: compute dtype of every conv (None follows the input's,
    torch.bfloat16 for the bf16 serving mode)."""

    def __init__(self, cnum: int = 16, dtype: Optional[torch.dtype] = None,
                 compute_offsets: bool = False):
        super().__init__()
        self.cnum, self.dtype = cnum, dtype
        self.coarse_generator = CoarseGenerator(cnum, dtype)
        self.fine_generator = FineGenerator(cnum, dtype, compute_offsets)

    def forward(self, x, mask, cam, slice_ratio) -> GeneratorOut:
        coarse_seg, x_stage1, pred1_h = self.coarse_generator(x, mask, cam, slice_ratio)
        fine_seg, x_stage2, offsets, pred2_h = self.fine_generator(
            x, x_stage1, mask, coarse_seg, slice_ratio
        )
        c = lambda t: t.contiguous()
        return GeneratorOut(
            c(coarse_seg), c(fine_seg), c(x_stage1), c(x_stage2), offsets,
            pred1_h, pred2_h,
        )


@torch.no_grad()
def init_generator(gen: Generator, generator: torch.Generator) -> Generator:
    """The flax generator's own initialisation, drawn from `generator`:
    lecun-normal conv and dense kernels, zero biases, spectral-norm vectors
    l2(N(0, 1)). The reference builds the generator without init_net, so
    --init_type does not apply to it."""
    for m in gen.modules():
        if isinstance(m, SNConv):
            lecun_normal_(m.weight, generator)
            m.bias.zero_()
            m.u.copy_(_l2(torch.randn(m.u.shape, generator=generator)))
        elif isinstance(m, nn.Linear):
            lecun_normal_(m.weight, generator)
            m.bias.zero_()
    return gen
