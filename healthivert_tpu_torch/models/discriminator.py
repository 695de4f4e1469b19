"""PatchGAN discriminators and the GAN losses.

Counterpart of healthivert_tpu/models/discriminator.py:28-126
(`NLayerDiscriminator`, `PixelDiscriminator`, `gan_loss`), with the same
module names (conv0, conv{n}, norm{n}, conv_out) so that the flax trees map
onto the state dict one to one (utils/weights.py). Inputs are NHWC, as in
the JAX package; inside, the convs run NCHW. Weights are OIHW, float32.

BatchNorm follows flax, not torch's defaults: it normalizes with the batch
statistics in float32 and returns float32, eps 1e-5, and updates its running
statistics as r = 0.9 r + 0.1 batch, with the *biased* batch variance
(torch's own BatchNorm2d would use the unbiased one). A forward may be told
not to update them (`update_stats=False`): the generator's loss head reads
the discriminators that way, and the JAX step throws that update away.

Under a process group of several ranks the statistics are those of the
global batch, as flax computes them under GSPMD (JAX
models/discriminator.py:8-14): one differentiable all_reduce of the local
float32 sums of x and x^2 and the count, var = max(E[x^2] - E[x]^2, 0)
(flax's fast variance); the gradient flows through the global statistics.
nn.SyncBatchNorm is not used: it gathers with all_gather.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..parallel import distributed
from .layers import normal_init, weight_init


class BatchNorm(nn.Module):
    """flax.linen.BatchNorm(momentum=0.9, epsilon=1e-5). In training mode
    (the discriminators always run so in the JAX step) it normalises with
    the batch statistics; in eval mode with the running ones, as flax's
    use_running_average=True does for the legacy networks at train=False.
    `gain_scale` says how init_weights draws the scale: from N(1, gain), or
    flax's ones when False."""

    def __init__(self, features: int, momentum: float = 0.9, eps: float = 1e-5,
                 gain_scale: bool = True):
        super().__init__()
        self.momentum, self.eps, self.gain_scale = momentum, eps, gain_scale
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x, update_stats: bool = True):
        x = x.float()
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight,
                                self.bias, training=False, eps=self.eps)
        if distributed.is_multiprocess():
            return self._global_batch(x, update_stats)
        y = F.batch_norm(x, None, None, self.weight, self.bias, training=True, eps=self.eps)
        if update_stats:
            with torch.no_grad():
                var, mean = torch.var_mean(x, dim=(0, 2, 3), unbiased=False)
                self._update(mean, var)
        return y

    @torch.no_grad()
    def _update(self, mean, var):
        self.running_mean.mul_(self.momentum).add_((1.0 - self.momentum) * mean)
        self.running_var.mul_(self.momentum).add_((1.0 - self.momentum) * var)

    def _global_batch(self, x, update_stats):
        """Normalise with the statistics of the batch over all ranks, as
        flax's _compute_stats and _normalize do; every rank updates its
        running statistics with the same global mean and variance. Under a
        model axis every data shard's sums and count enter replicas() times,
        which leaves the means, and so the statistics, unchanged."""
        c = x.shape[1]
        count = x.new_full((1,), x.numel() // c)
        sums = distributed.all_reduce_sum(
            torch.cat([x.sum(dim=(0, 2, 3)), (x * x).sum(dim=(0, 2, 3)), count]))
        mean, mean2 = sums[:c] / sums[-1], sums[c:2 * c] / sums[-1]
        var = torch.clamp(mean2 - mean * mean, min=0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (x - mean[None, :, None, None]) * mul[None, :, None, None] \
            + self.bias[None, :, None, None]
        if update_stats:
            self._update(mean.detach(), var.detach())
        return y


def _instance_norm(x):
    """torch InstanceNorm2d(affine=False): per-sample spatial statistics."""
    var, mean = torch.var_mean(x, dim=(2, 3), keepdim=True, unbiased=False)
    return (x - mean) * torch.rsqrt(var + 1e-5)


class _Discriminator(nn.Module):
    """Shared plumbing: a conv in the compute dtype, the norm layers, init."""

    def __init__(self, norm: str, dtype: Optional[torch.dtype]):
        super().__init__()
        if norm not in ("batch", "instance", "none"):
            raise NotImplementedError(f"normalization layer [{norm}] is not found")
        self.norm, self.dtype = norm, dtype

    def _conv(self, name, x):
        conv = getattr(self, name)
        dt = self.dtype or torch.float32
        b = conv.bias.to(dt) if conv.bias is not None else None
        return F.conv2d(x.to(dt), conv.weight.to(dt), b, conv.stride, conv.padding)

    def _norm_layer(self, name, x, update_stats):
        if self.norm == "batch":
            return getattr(self, name)(x, update_stats)
        if self.norm == "instance":
            return _instance_norm(x.float())
        return x

    def _add_norm(self, name, features):
        if self.norm == "batch":
            self.add_module(name, BatchNorm(features))

    def init_weights(self, generator: torch.Generator, init_type: str = "normal",
                     init_gain: float = 0.02):
        """The reference's init_weights: conv kernels by init_type, biases
        zero, BatchNorm scales from N(1, init_gain), running stats reset."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                weight_init(m.weight, generator, init_type, init_gain)
                if m.bias is not None:
                    nn.init.zeros_(m.bias)
            elif isinstance(m, BatchNorm):
                normal_init(m.weight, generator, init_gain, mean=1.0)
                nn.init.zeros_(m.bias)
                m.running_mean.zero_()
                m.running_var.fill_(1.0)
        return self


class NLayerDiscriminator(_Discriminator):
    """The 70 x 70 PatchGAN: 4 x 4 convs, strides 2, ..., 2, 1, 1, LeakyReLU
    0.2, BatchNorm; (B, H, W, 1) -> (B, H/8 - 2, W/8 - 2, 1) logits for
    n_layers = 3. Biases only on the first and last convs, except with
    instance norm."""

    def __init__(self, in_channels: int = 1, ndf: int = 64, n_layers: int = 3,
                 norm: str = "batch", dtype: Optional[torch.dtype] = None):
        super().__init__(norm, dtype)
        self.n_layers = n_layers
        bias = norm == "instance"
        self.conv0 = nn.Conv2d(in_channels, ndf, 4, 2, 1)
        nf_prev = 1
        for n in range(1, n_layers):
            nf = min(2**n, 8)
            self.add_module(f"conv{n}", nn.Conv2d(ndf * nf_prev, ndf * nf, 4, 2, 1, bias=bias))
            self._add_norm(f"norm{n}", ndf * nf)
            nf_prev = nf
        nf = min(2**n_layers, 8)
        self.add_module(f"conv{n_layers}", nn.Conv2d(ndf * nf_prev, ndf * nf, 4, 1, 1, bias=bias))
        self._add_norm(f"norm{n_layers}", ndf * nf)
        self.conv_out = nn.Conv2d(ndf * nf, 1, 4, 1, 1)

    def forward(self, x, update_stats: bool = True):
        h = F.leaky_relu(self._conv("conv0", x.permute(0, 3, 1, 2)), 0.2)
        for n in range(1, self.n_layers + 1):
            h = self._norm_layer(f"norm{n}", self._conv(f"conv{n}", h), update_stats)
            h = F.leaky_relu(h, 0.2)
        return self._conv("conv_out", h).permute(0, 2, 3, 1)


class PixelDiscriminator(_Discriminator):
    """The 1 x 1 PixelGAN (reference networks.py:724-753)."""

    def __init__(self, in_channels: int = 1, ndf: int = 64, norm: str = "batch",
                 dtype: Optional[torch.dtype] = None):
        super().__init__(norm, dtype)
        self.conv0 = nn.Conv2d(in_channels, ndf, 1)
        self.conv1 = nn.Conv2d(ndf, ndf * 2, 1, bias=norm == "instance")
        self._add_norm("norm1", ndf * 2)
        self.conv_out = nn.Conv2d(ndf * 2, 1, 1)

    def forward(self, x, update_stats: bool = True):
        h = F.leaky_relu(self._conv("conv0", x.permute(0, 3, 1, 2)), 0.2)
        h = self._norm_layer("norm1", self._conv("conv1", h), update_stats)
        h = F.leaky_relu(h, 0.2)
        return self._conv("conv_out", h).permute(0, 2, 3, 1)


def gan_loss(logits: torch.Tensor, target_is_real: bool, mode: str = "vanilla") -> torch.Tensor:
    """GANLoss (reference networks.py:212-278), in float32: vanilla =
    BCE-with-logits against a constant label, lsgan = MSE, wgangp = -+mean."""
    logits = logits.float()
    if mode == "vanilla":
        target = 1.0 if target_is_real else 0.0
        return torch.mean(F.softplus(logits) - target * logits)
    if mode == "lsgan":
        target = 1.0 if target_is_real else 0.0
        return torch.mean((logits - target) ** 2)
    if mode == "wgangp":
        return -torch.mean(logits) if target_is_real else torch.mean(logits)
    raise ValueError(f"gan mode {mode} not implemented")
