"""Spectrally normalized conv blocks of the generator, and the initialisers
of the discriminators.

Counterpart of healthivert_tpu/models/layers.py (`CALIB_PERCENTILES` :21,
`_ACT` :23-30, `SNConv` :37-109 with its int8 path `_int8_conv` :111-191,
`Conv2dBlock` :194-222, `normal_init`/`weight_init` :225-266). Modules run
NCHW inside; the weight is OIHW.

Spectral norm follows the JAX package, not torch.nn.utils.spectral_norm:
with the stored u, v = l2(W^T u), u_new = l2(W v), sigma = u_new . (W v),
l2(x) = x / (||x|| + 1e-12), and the kernel is divided by sigma. u and v
are constants for autodiff; the gradient reaches W through W / sigma and
through the W of sigma. A forward never updates u (the JAX train step
applies its generator with update_sn=False): training advances it
explicitly with `SNConv.power_iteration`. Without autograd the normalized
kernel is computed once per weight and reused until the weight or u
changes.

int8 (dtype="int8", inference only): a conv with at least 8 outputs
quantizes its spectrally normalised weight per output channel and its input
per sample (or with a static scale), sums int8 products in int32
(`ops.int8_conv.int8_conv2d`), and returns bf16; a narrower one (the
1-channel heads) runs bf16. `int8_scope` sets static activation scales and
collects calibration statistics for the convs that run inside it.
"""

from __future__ import annotations

import contextlib
import contextvars
import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.int8_conv import int8_conv2d

# the quantile grid of the int8 calibration statistics (act_pq); a static
# scale picks one of them (pix2pix.calib_to_quant)
CALIB_PERCENTILES = (99.0, 99.5, 99.9, 99.99)
INT8 = "int8"  # the int8 compute dtype of SNConv and Generator

_ACT = {
    "relu": F.relu,
    "elu": F.elu,
    "lrelu": lambda x: F.leaky_relu(x, 0.2),
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
    "none": lambda x: x,
}


def _l2(x, eps=1e-12):
    return x / (torch.linalg.vector_norm(x) + eps)


def _power_step(mat: torch.Tensor, u: torch.Tensor):
    """(v, u_new) of one power iteration on mat (out, d) from u, detached."""
    with torch.no_grad():
        v = _l2(mat.T @ u)
        return v, _l2(mat @ v)


def spectral_normalize(weight: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """weight / sigma with one power iteration from u (float32); u and v
    carry no gradient, the weight does (in both places it appears)."""
    mat = weight.reshape(weight.shape[0], -1)  # (out, d)
    v, u_new = _power_step(mat, u)
    sigma = u_new @ (mat @ v)
    return weight / sigma


# (static scales {SNConv: 0-d float32 tensor} or None, calibration
# statistics {SNConv: {"act_absmax", "act_pq"}} or None) of the int8 convs
# running in this context
_INT8_SCOPE = contextvars.ContextVar("int8_scope", default=(None, None))


@contextlib.contextmanager
def int8_scope(scales=None, calib=None):
    """Inside: an int8 SNConv found in `scales` quantizes its input with that
    static per-tensor scale (the others with per-sample dynamic ones), and
    each int8 SNConv max-merges its input's |x| max and CALIB_PERCENTILES
    quantiles into `calib[conv]` when `calib` is a dict. Nothing outlives
    the block."""
    token = _INT8_SCOPE.set((scales, calib))
    try:
        yield
    finally:
        _INT8_SCOPE.reset(token)


def _record_calib(calib, conv, xf):
    """The JAX layer's calibration sow (layers.py:132-157): the |x| max, and
    the quantiles of |x| on a spatially strided subsample of at most ~2^20
    elements, each max-merged with what the conv recorded before."""
    stride = max(1, math.ceil(math.sqrt(xf.numel() / float(1 << 20))))
    sub = xf[:, :, ::stride, ::stride].abs().flatten()
    q = torch.tensor(CALIB_PERCENTILES, dtype=torch.float32, device=xf.device) / 100
    stats = {"act_absmax": xf.abs().amax(), "act_pq": torch.quantile(sub, q)}
    prev = calib.get(conv)
    calib[conv] = stats if prev is None else {k: torch.maximum(prev[k], v)
                                              for k, v in stats.items()}


def quantize_weight(w: torch.Tensor):
    """(int8 weight, float32 per-output-channel scale (O,)) of a float32
    OIHW kernel: symmetric, scale max|w| / 127 over dims 1-3, floored at
    1e-12 before the division."""
    sw = w.abs().amax(dim=(1, 2, 3)).clamp_min(1e-12) / 127.0
    qw = torch.round(w / sw.view(-1, 1, 1, 1)).clamp(-127, 127).to(torch.int8)
    return qw, sw


def int8_conv(x, qw, sw, bias, stride, padding, dilation, act_scale=None):
    """The JAX layer's `_int8_conv` (layers.py:111-191) on a quantized
    weight: the input quantized symmetrically with `act_scale` (a static
    per-tensor scale, floored at 1e-12) or, without one, per sample with
    max|x| over (C, H, W) / 127; int8 x int8 summed in int32; dequantized as
    y * (sx * sw) + bias in float32 (the product of the scales first, as
    the JAX layer forms it), returned as bf16."""
    # sx has four dims, so that x / sx and y * scale compute in float32
    # whatever x's and y's dtypes (a 0-d float32 scale would leave a bf16 x
    # in bf16)
    if act_scale is not None:
        sx = act_scale.float().clamp_min(1e-12).reshape(1, 1, 1, 1)
    else:
        absmax = torch.linalg.vector_norm(x, float("inf"), dim=(1, 2, 3), keepdim=True)
        sx = absmax.float().clamp_min(1e-12) / 127.0
    qx = torch.round(x / sx).clamp_(-127, 127).to(torch.int8)
    y = int8_conv2d(qx, qw, stride, padding, dilation) * (sx * sw.view(1, -1, 1, 1))
    return y.add_(bias.float().view(1, -1, 1, 1)).to(torch.bfloat16)


class SNConv(nn.Module):
    """2-D conv with bias and spectral normalization, symmetric integer
    padding (every conv of the generator is one).

    dtype: the compute dtype (None follows the input's, or "int8"). Input,
    kernel and bias are cast to it, as the JAX layer does; under "int8" a
    conv with fewer than 8 outputs runs bf16."""

    def __init__(self, in_features, features, kernel_size=3, stride=1,
                 padding=0, dilation=1, dtype=None):
        super().__init__()
        k = kernel_size
        self.stride, self.padding, self.dilation = stride, padding, dilation
        self.dtype = dtype
        self.weight = nn.Parameter(torch.zeros(features, in_features, k, k))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("u", _l2(torch.ones(features)))
        self._cache_key = None
        self._cache = None
        self._q_key = None
        self._q_cache = None

    def normalized_weight(self) -> torch.Tensor:
        """weight / sigma in float32. Under autograd it is computed anew on
        every call; otherwise only when weight or u change."""
        w, u = self.weight, self.u
        if torch.is_grad_enabled() and w.requires_grad:
            return spectral_normalize(w.float(), u.float())
        key = (w.data_ptr(), w._version, u.data_ptr(), u._version)
        if key != self._cache_key:
            with torch.no_grad():
                self._cache = spectral_normalize(w.float(), u.float())
            self._cache_key = key
        return self._cache

    def quantized_weight(self):
        """`quantize_weight` of the normalized weight, kept until the weight
        or u change (int8 runs without autograd)."""
        key = (self.weight.data_ptr(), self.weight._version, self.u.data_ptr(), self.u._version)
        if key != self._q_key:
            with torch.no_grad():
                self._q_cache = quantize_weight(self.normalized_weight())
            self._q_key = key
        return self._q_cache

    @torch.no_grad()
    def power_iteration(self):
        """Advance u by one power iteration from the current weight (the
        JAX package's `_update_sn_tree` for this conv)."""
        mat = self.weight.float().reshape(self.weight.shape[0], -1)
        self.u.copy_(_power_step(mat, self.u.float())[1])

    def forward(self, x):
        dt = self.dtype or x.dtype
        if dt == INT8:
            if self.weight.shape[0] >= 8:
                return self._int8_forward(x)
            dt = torch.bfloat16
        w = self.normalized_weight().to(dt)
        return F.conv2d(x.to(dt), w, self.bias.to(dt), self.stride, self.padding,
                        self.dilation)


    def _int8_forward(self, x):
        scales, calib = _INT8_SCOPE.get()
        if calib is not None:
            _record_calib(calib, self, x.float())
        qw, sw = self.quantized_weight()
        scale = None if scales is None else scales.get(self)
        return int8_conv(x, qw, sw, self.bias, self.stride, self.padding, self.dilation, scale)


class Conv2dBlock(nn.Module):
    """SN conv then activation (the reference's gen_conv; ELU default)."""

    def __init__(self, in_features, features, kernel_size=3, stride=1,
                 padding=0, dilation=1, activation="elu", dtype=None):
        super().__init__()
        self.conv = SNConv(in_features, features, kernel_size, stride, padding,
                           dilation, dtype=dtype)
        self.activation = activation

    def forward(self, x):
        return _ACT[self.activation](self.conv(x))


def normal_init(tensor: torch.Tensor, generator: torch.Generator, stddev: float = 0.02,
                mean: float = 0.0) -> torch.Tensor:
    """Fill `tensor` from N(mean, stddev) (torch init.normal_(w, mean, 0.02)
    of the reference, for conv kernels and BatchNorm scales)."""
    with torch.no_grad():
        draw = torch.randn(tensor.shape, generator=generator, dtype=torch.float32)
        return tensor.copy_(mean + stddev * draw)


def _fans(weight: torch.Tensor):
    """(fan_in, fan_out) of an OIHW conv or (out, in) dense weight."""
    receptive = math.prod(weight.shape[2:])
    return weight.shape[1] * receptive, weight.shape[0] * receptive


def weight_init(weight: torch.Tensor, generator: torch.Generator,
                init_type: str = "normal", init_gain: float = 0.02) -> torch.Tensor:
    """Fill a conv kernel as --init_type/--init_gain ask (the JAX package's
    `weight_init`, reference networks.py:68-99):
      normal      N(0, init_gain)
      xavier      N(0, init_gain^2 * 2 / (fan_in + fan_out))
      kaiming     N(0, 2 / fan_in) (init_gain is not read, as in the reference)
      orthogonal  init_gain times orthonormal columns of the (kh kw in, out)
                  matrix, flax's flattening with column_axis=-1
    The draws come from `generator` and differ from jax.random's: the
    distributions are the same, the numbers are not."""
    fan_in, fan_out = _fans(weight)
    if init_type == "normal":
        return normal_init(weight, generator, init_gain)
    if init_type == "xavier":
        return normal_init(weight, generator, init_gain * (2.0 / (fan_in + fan_out)) ** 0.5)
    if init_type == "kaiming":
        return normal_init(weight, generator, (2.0 / fan_in) ** 0.5)
    if init_type == "orthogonal":
        out_f = weight.shape[0]
        rows = weight.numel() // out_f
        a = torch.randn((max(rows, out_f), min(rows, out_f)), generator=generator)
        q, r = torch.linalg.qr(a)
        q = q * torch.sign(torch.diagonal(r))
        mat = q if rows >= out_f else q.T  # (rows, out_f)
        if weight.dim() == 4:
            o, i, kh, kw = weight.shape
            mat = mat.reshape(kh, kw, i, o).permute(3, 2, 0, 1)
        else:
            mat = mat.T
        with torch.no_grad():
            return weight.copy_(init_gain * mat)
    raise NotImplementedError(f"initialization method [{init_type}] is not implemented")


def lecun_normal_(tensor: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """flax's default kernel initialiser: a normal truncated to two standard
    deviations, scaled to variance 1 / fan_in (the generator's own init)."""
    fan_in, _ = _fans(tensor)
    std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
    draw = torch.randn(tensor.shape, generator=generator)
    bad = draw.abs() > 2.0
    while bool(bad.any()):
        draw[bad] = torch.randn(int(bad.sum()), generator=generator)
        bad = draw.abs() > 2.0
    with torch.no_grad():
        return tensor.copy_(std * draw)
