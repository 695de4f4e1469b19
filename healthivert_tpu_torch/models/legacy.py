"""The legacy networks: the seg discriminator of --netD seg, the original
pix2pix generators, the dual-head UNet and the WGAN-GP penalty.

Counterpart of healthivert_tpu/models/legacy.py: `_down` (:26-33), `_up`
(:36-47), `DualHeadUNet` (:50-84), `UnetGenerator` (:87-114), `ResnetBlock`
and `ResnetGenerator` (:117-168), `SegDiscriminator` (:171-215) and
`gradient_penalty` (:218-229). The module names are the flax names
(``enc0_conv``, ``enc1_bn``, ``dec1``, ``up0_deconv``, ``block3.conv1``, ...),
so the flax trees map onto the state dicts one to one
(utils/weights.flax_legacy_to_state_dict). Inputs and outputs are NHWC, as
in the JAX package; inside, the convs run NCHW in float32 (the flax modules
take no dtype, so their float32 parameters promote a bf16 input).

Training and eval mode are flax's `train`: BatchNorm normalises with the
batch statistics and updates its running ones in training mode
(`.train()`), and normalises with the running statistics in eval mode.

flax's nn.ConvTranspose (transpose_kernel=False) convolves the input,
dilated by the stride, with its kernel as given, after padding it by lax's
explicit (lo, hi) pairs. torch's conv_transpose2d does the same with the
kernel flipped in space and its in and out swapped, and with the pads
(k - 1 - p, k - 1 - p + output_padding). So `ConvTranspose` keeps its weight
in torch's (in, out, kh, kw) layout, the flax kernel flipped, and derives p
and output_padding from (lo, hi); a high pad below the low one is cropped
from the output. The shapes follow lax, not the reference's comments:
`dec1` (k 4, stride 1, pads (1, 1)) gives in - 1, so a 256 x 256 input
gives 30 x 30 logits and a 240 x 240 seg map.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from .discriminator import BatchNorm
from .layers import normal_init, weight_init


def same_pads(k: int, s: int):
    """lax's (lo, hi) pads of a 'SAME' transposed conv
    (jax._src.lax.convolution._conv_transpose_padding)."""
    pad_len = k + s - 2
    lo = k - 1 if s > k - 1 else math.ceil(pad_len / 2)
    return lo, pad_len - lo


def conv_transpose(x, weight, bias, stride: int, pads):
    """flax ConvTranspose of NCHW `x`: weight (in, out, k, k) in torch's
    layout (the flax kernel flipped), pads lax's ((lo, hi), (lo, hi))."""
    k = weight.shape[-1]
    padding, out_pad, crop = [], [], []
    for lo, hi in pads:
        if not 0 <= lo <= k - 1 or not hi - lo < stride:
            raise ValueError(f"pads {pads} of a {k} x {k} stride-{stride} transposed conv")
        padding.append(k - 1 - lo)
        out_pad.append(max(hi - lo, 0))
        crop.append(min(hi - lo, 0))
    y = F.conv_transpose2d(x, weight, bias, stride, padding, out_pad)
    if any(crop):
        y = y[..., :y.shape[-2] + crop[0], :y.shape[-1] + crop[1]]
    return y


class ConvTranspose(nn.Module):
    """flax nn.ConvTranspose(cout, (k, k), (s, s), padding): padding is
    lax's (lo, hi) pair, used on both axes, or "SAME"."""

    def __init__(self, cin: int, cout: int, k: int, stride: int, padding, bias: bool = True):
        super().__init__()
        self.stride = stride
        pair = same_pads(k, stride) if padding == "SAME" else tuple(padding)
        self.pads = (pair, pair)
        self.weight = nn.Parameter(torch.empty(cin, cout, k, k))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None

    def forward(self, x):
        return conv_transpose(x, self.weight, self.bias, self.stride, self.pads)

    def init_weight(self, generator: torch.Generator, init_type: str, init_gain: float):
        """weight_init(init_type, init_gain, transpose=True) of the JAX
        package, drawn on the flax kernel, which is then flipped: kaiming
        takes the kernel's fan-out (out k k), as the reference's deconv
        fan-in; orthogonal flattens flax's (kh kw in, out)."""
        cin, cout, k, _ = self.weight.shape
        flax_oihw = torch.empty(cout, cin, k, k)
        if init_type == "kaiming":
            normal_init(flax_oihw, generator, math.sqrt(2.0 / (cout * k * k)))
        else:
            weight_init(flax_oihw, generator, init_type, init_gain)
        with torch.no_grad():
            self.weight.copy_(flax_oihw.flip(2, 3).transpose(0, 1))


class _Legacy(nn.Module):
    """Shared plumbing: the `_down` and `_up` stages and the init."""

    def __init__(self, init_type: str = "normal", init_gain: float = 0.02):
        super().__init__()
        self.init_type, self.init_gain = init_type, init_gain

    def _add_down(self, name, cin, f, norm=True, bias=None):
        """`_down`: a 4 x 4 stride-2 conv (a bias without the norm), a
        BatchNorm with its scale from N(1, gain), LeakyReLU 0.2."""
        use_bias = not norm if bias is None else bias
        self.add_module(f"{name}_conv", nn.Conv2d(cin, f, 4, 2, 1, bias=use_bias))
        if norm:
            self.add_module(f"{name}_bn", BatchNorm(f))

    def _down(self, name, h):
        h = getattr(self, f"{name}_conv")(h)
        bn = getattr(self, f"{name}_bn", None)
        if bn is not None:
            h = bn(h)
        return F.leaky_relu(h, 0.2)

    def _add_up(self, name, cin, f):
        """`_up`: a 4 x 4 stride-2 transposed conv without bias, pads (2, 2)
        (the exact 2x upsample), a BatchNorm with its scale from N(1, gain)."""
        self.add_module(f"{name}_deconv", ConvTranspose(cin, f, 4, 2, (2, 2), bias=False))
        self.add_module(f"{name}_bn", BatchNorm(f))

    def _up(self, name, h, act="relu"):
        h = getattr(self, f"{name}_bn")(getattr(self, f"{name}_deconv")(h))
        if act == "relu":
            return F.relu(h)
        if act == "sigmoid":
            return torch.sigmoid(h)
        return h

    def init_weights(self, generator: torch.Generator, init_type: Optional[str] = None,
                     init_gain: Optional[float] = None):
        """The JAX module's initialisers, layer by layer: conv kernels by
        init_type (transposed convs as `ConvTranspose.init_weight`), biases
        zero, the scales of `_down`'s and `_up`'s BatchNorms from N(1, gain)
        and the others flax's ones, running statistics reset. The draws come
        from `generator`; their distributions are the JAX package's."""
        init_type = init_type or self.init_type
        gain = self.init_gain if init_gain is None else init_gain
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                weight_init(m.weight, generator, init_type, gain)
            elif isinstance(m, ConvTranspose):
                m.init_weight(generator, init_type, gain)
            elif isinstance(m, BatchNorm):
                if m.gain_scale:
                    normal_init(m.weight, generator, gain, mean=1.0)
                else:
                    nn.init.ones_(m.weight)
                m.running_mean.zero_()
                m.running_var.fill_(1.0)
            else:
                continue
            if m.bias is not None:
                nn.init.zeros_(m.bias)
        return self


def _nchw(x):
    return x.float().permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


class DualHeadUNet(_Legacy):
    """Shared encoder, two decoders (CT raw, mask sigmoid) with skip
    concats; returns (ct, mask)."""

    def __init__(self, in_channels: int = 1, out_features: int = 1, num_downs: int = 5,
                 ngf: int = 64, init_type: str = "normal", init_gain: float = 0.02):
        super().__init__(init_type, init_gain)
        self.num_downs = num_downs
        widths = [ngf * 2**i for i in range(num_downs)]
        cin = in_channels
        for i, f in enumerate(widths):
            self._add_down(f"down{i}", cin, f, norm=i != num_downs - 1)
            cin = f
        for tag in ("ct", "mask"):
            h = widths[-1]
            for j, i in enumerate(reversed(range(num_downs))):
                f = ngf * 2 ** (i - 1) if i > 0 else out_features
                self._add_up(f"{tag}_up{j}", h, f)
                h = f + (widths[-2 - j] if j < num_downs - 1 else 0)

    def forward(self, x):
        feats = []
        h = _nchw(x)
        for i in range(self.num_downs):
            h = self._down(f"down{i}", h)
            feats.append(h)

        def decode(tag, final_act):
            h = feats[-1]
            for j, i in enumerate(reversed(range(self.num_downs))):
                h = self._up(f"{tag}_up{j}", h, final_act if i == 0 else "relu")
                if j < len(feats) - 1:
                    h = torch.cat([h, feats[-2 - j]], dim=1)
            return _nhwc(h)

        return decode("ct", "none"), decode("mask", "sigmoid")


class UnetGenerator(_Legacy):
    """The plain recursive pix2pix UNet (unet_256 at num_downs=8)."""

    def __init__(self, in_channels: int = 1, out_features: int = 1, num_downs: int = 8,
                 ngf: int = 64, init_type: str = "normal", init_gain: float = 0.02):
        super().__init__(init_type, init_gain)
        self.num_downs = num_downs
        widths = [min(ngf * 2**i, ngf * 8) for i in range(num_downs)]
        cin = in_channels
        for i, f in enumerate(widths):
            self._add_down(f"down{i}", cin, f, norm=0 < i < num_downs - 1)
            cin = f
        for j, i in enumerate(reversed(range(num_downs))):
            f = widths[i - 1] if i > 0 else out_features
            self._add_up(f"up{j}", cin, f)
            cin = 2 * f if i > 0 else f

    def forward(self, x):
        feats = []
        h = _nchw(x)
        for i in range(self.num_downs):
            h = self._down(f"down{i}", h)
            feats.append(h)
        for j, i in enumerate(reversed(range(self.num_downs))):
            h = self._up(f"up{j}", h, "relu" if i > 0 else "none")
            if i > 0:
                h = torch.cat([h, feats[i - 1]], dim=1)
        return _nhwc(torch.tanh(h))


class ResnetBlock(nn.Module):
    """Reflect pad, 3 x 3 conv, BatchNorm, ReLU, reflect pad, 3 x 3 conv,
    BatchNorm, plus the input (NCHW)."""

    def __init__(self, features: int):
        super().__init__()
        self.conv1 = nn.Conv2d(features, features, 3)
        self.bn1 = BatchNorm(features, gain_scale=False)
        self.conv2 = nn.Conv2d(features, features, 3)
        self.bn2 = BatchNorm(features, gain_scale=False)

    def forward(self, x):
        h = F.relu(self.bn1(self.conv1(F.pad(x, (1, 1, 1, 1), mode="reflect"))))
        return x + self.bn2(self.conv2(F.pad(h, (1, 1, 1, 1), mode="reflect")))


class ResnetGenerator(_Legacy):
    """The resnet_9blocks backbone: a 7 x 7 stem, two stride-2 downs, the
    blocks at 4 ngf, two 'SAME' stride-2 transposed convs, a 7 x 7 head,
    tanh. Its BatchNorm scales start at flax's ones."""

    def __init__(self, in_channels: int = 1, out_features: int = 1, ngf: int = 64,
                 n_blocks: int = 9, init_type: str = "normal", init_gain: float = 0.02):
        super().__init__(init_type, init_gain)
        self.n_blocks = n_blocks
        self.stem = nn.Conv2d(in_channels, ngf, 7)
        self.stem_bn = BatchNorm(ngf, gain_scale=False)
        for i in range(2):
            self.add_module(f"down{i}", nn.Conv2d(ngf * 2**i, ngf * 2 ** (i + 1), 3, 2, 1))
            self.add_module(f"down{i}_bn", BatchNorm(ngf * 2 ** (i + 1), gain_scale=False))
        for i in range(n_blocks):
            self.add_module(f"block{i}", ResnetBlock(ngf * 4))
        for i in range(2):
            self.add_module(f"up{i}", ConvTranspose(ngf * 2 ** (2 - i), ngf * 2 ** (1 - i),
                                                    3, 2, "SAME"))
            self.add_module(f"up{i}_bn", BatchNorm(ngf * 2 ** (1 - i), gain_scale=False))
        self.head = nn.Conv2d(ngf, out_features, 7)

    def forward(self, x):
        h = F.pad(_nchw(x), (3, 3, 3, 3), mode="reflect")
        h = F.relu(self.stem_bn(self.stem(h)))
        for i in range(2):
            h = F.relu(getattr(self, f"down{i}_bn")(getattr(self, f"down{i}")(h)))
        for i in range(self.n_blocks):
            h = getattr(self, f"block{i}")(h)
        for i in range(2):
            h = F.relu(getattr(self, f"up{i}_bn")(getattr(self, f"up{i}")(h)))
        h = self.head(F.pad(h, (3, 3, 3, 3), mode="reflect"))
        return _nhwc(torch.tanh(h))


class SegDiscriminator(_Legacy):
    """A PatchGAN encoder shared by the patch logits and a seg decoder of
    transposed convs without skips (--netD seg). Returns (logits,
    sigmoid(seg)); float32 whatever the input's dtype, as in the JAX package.

    `seg=False` returns the logits alone, as the train step needs them (the
    JAX `_d_forward` drops the seg map): the decoder then runs only to
    update its BatchNorm running statistics, without autograd, so none of
    its activations is kept, and not at all when `update_stats` is False."""

    def __init__(self, in_channels: int = 1, ndf: int = 64, n_layers: int = 3,
                 init_type: str = "normal", init_gain: float = 0.02):
        super().__init__(init_type, init_gain)
        self.n_layers = n_layers
        self._add_down("enc0", in_channels, ndf, norm=False, bias=True)
        nf_prev = 1
        for n in range(1, n_layers):
            nf = min(2**n, 8)
            self._add_down(f"enc{n}", ndf * nf_prev, ndf * nf)
            nf_prev = nf
        nf = min(2**n_layers, 8)
        self.enc_final = nn.Conv2d(ndf * nf_prev, ndf * nf, 4, 1, 1, bias=False)
        self.enc_final_bn = BatchNorm(ndf * nf, gain_scale=False)
        self.patch_out = nn.Conv2d(ndf * nf, 1, 4, 1, 1)
        cin = ndf * nf
        for i in range(1, n_layers + 1):
            f = max(ndf * min(2 ** (n_layers - i), 8), ndf)
            stride, pads = (1, (1, 1)) if i == 1 else (2, (2, 2))
            self.add_module(f"dec{i}", ConvTranspose(cin, f, 4, stride, pads))
            self.add_module(f"dec{i}_bn", BatchNorm(f, gain_scale=False))
            cin = f
        self.seg_out = ConvTranspose(cin, 1, 4, 2, (2, 2))

    def _decode(self, h, update_stats):
        for i in range(1, self.n_layers + 1):
            h = getattr(self, f"dec{i}_bn")(getattr(self, f"dec{i}")(h), update_stats)
            h = F.relu(h)
        return torch.sigmoid(self.seg_out(h))

    def forward(self, x, update_stats: bool = True, seg: bool = True):
        h = F.leaky_relu(self.enc0_conv(_nchw(x)), 0.2)
        for n in range(1, self.n_layers):
            h = getattr(self, f"enc{n}_bn")(getattr(self, f"enc{n}_conv")(h), update_stats)
            h = F.leaky_relu(h, 0.2)
        h = F.leaky_relu(self.enc_final_bn(self.enc_final(h), update_stats), 0.2)
        logits = _nhwc(self.patch_out(h))
        if seg:
            return logits, _nhwc(self._decode(h, update_stats))
        if update_stats and self.training:
            with torch.no_grad():
                self._decode(h.detach(), True)
        return logits


def gradient_penalty(disc_fn, real, fake, alpha=None, generator: torch.Generator = None,
                     constant: float = 1.0, lambda_gp: float = 10.0):
    """WGAN-GP penalty on mixed samples: lambda_gp * mean((||grad D(mix)||
    - constant)^2), mix = alpha real + (1 - alpha) fake with one alpha a
    sample. `alpha` (B, 1, ..., 1) may be given; otherwise it is drawn from
    U(0, 1) with `generator` (a CPU torch.Generator). The gradient keeps its
    graph (create_graph), so the penalty is differentiable."""
    shape = (real.shape[0],) + (1,) * (real.dim() - 1)
    if alpha is None:
        alpha = torch.rand(shape, generator=generator)
    alpha = alpha.to(real.device, real.dtype).reshape(shape)
    mixed = alpha * real + (1 - alpha) * fake
    if not mixed.requires_grad:
        mixed.requires_grad_(True)
    grads, = torch.autograd.grad(disc_fn(mixed).sum(), mixed, create_graph=True)
    norm = torch.linalg.vector_norm(grads.reshape(real.shape[0], -1) + 1e-16, dim=1)
    return torch.mean((norm - constant) ** 2) * lambda_gp
