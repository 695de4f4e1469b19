"""Plain PyTorch reference of HealthiVert-GAN: the two-stage generator with
contextual attention and the SHRM heads, the three basic PatchGAN
discriminators, the losses and one training step in the upstream's update
order (discriminators first, then the generator against the updated
discriminators; full-frame D3).

A frozen copy of the published model (github.com/zhibaishouheilab/
HealthiVert-GAN, models/inpaint_networks.py, models/networks.py
NLayerDiscriminator, models/pix2pix_model.py) in float32 with no kernels,
no cache and no batching tricks. Module and buffer names follow the state
dict of the system under test, so that one weight dict serves both sides.
Tensors are NHWC at the module boundaries, NCHW inside.

`quant` (None or "int8") rounds every conv's input and weight to a
symmetric per-tensor int8 grid before the conv (with a straight-through
gradient): the reference in a lower precision than the configuration
states, which the correctness check must reject.

The attention's norm is sqrt(max(|w|^2, 1e-8)), which equals the
published max(|w|, 1e-4) and has a zero gradient below it instead of the
0 * inf of differentiating max(sqrt(.), 1e-4) at a zero patch.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import torch
import torch.nn as nn
import torch.nn.functional as F

MAXHEIGHT = 40.0


def fake_int8(x: torch.Tensor) -> torch.Tensor:
    """x on a symmetric per-tensor int8 grid (scale max|x| / 127), with the
    identity as its gradient."""
    scale = x.detach().abs().amax().clamp_min(1e-12) / 127.0
    q = torch.round(x.detach() / scale).clamp(-127, 127) * scale
    return x + (q - x).detach()


def conv(x, w, b, stride=1, padding=0, dilation=1, quant=None):
    if quant == "int8":
        x, w = fake_int8(x), fake_int8(w)
    return F.conv2d(x, w, b, stride, padding, dilation)


# ------------------------------------------------------------------ image ops

def resize_nearest(x, out_h, out_w):
    """Nearest resize of NHWC with src = floor(dst * in / out)."""
    h, w = x.shape[1], x.shape[2]
    ih = torch.arange(out_h, device=x.device) * h // out_h
    iw = torch.arange(out_w, device=x.device) * w // out_w
    return x.index_select(1, ih).index_select(2, iw)


def sobel_edges(x):
    """Sobel magnitude clipped to 1 of (B, H, W, 1), replicate padding."""
    xp = F.pad(x.permute(0, 3, 1, 2), (1, 1, 1, 1), mode="replicate").permute(0, 2, 3, 1)
    tl, tc, tr = xp[:, :-2, :-2], xp[:, :-2, 1:-1], xp[:, :-2, 2:]
    ml, mr = xp[:, 1:-1, :-2], xp[:, 1:-1, 2:]
    bl, bc, br = xp[:, 2:, :-2], xp[:, 2:, 1:-1], xp[:, 2:, 2:]
    gx = (tr - tl) + 2.0 * (mr - ml) + (br - bl)
    gy = (tl + 2.0 * tc + tr) - (bl + 2.0 * bc + br)
    return torch.clamp(torch.sqrt(gx * gx + gy * gy), max=1.0)


def dice_coeff(pred, gt, eps=1e-5):
    n = pred.shape[0]
    p, g = pred.reshape(n, -1), gt.reshape(n, -1)
    return torch.mean((2.0 * (g * p).sum(1) + eps) / (p.sum(1) + g.sum(1) + eps))


def shrm_paste(fake_raw, real, pred_h, real_height, x1, x2):
    """Rows of the predicted height h = max(ceil(pred_h), height), centred on
    the vertebra, from the synthesized image; rows above and below from the
    real slice, shifted out by the added height. (B, H, W, C) images."""
    b, h = fake_raw.shape[0], fake_raw.shape[1]
    col = lambda v: v.reshape(b, 1).long()
    real_height, x1, x2 = col(real_height), col(x1), col(x2)
    height = torch.maximum(torch.ceil(pred_h.reshape(b, 1)).long(), real_height)
    hd2 = torch.div(height - real_height, 2, rounding_mode="floor")
    x_upper = x1 - hd2
    x_bottom = x_upper + height
    r = torch.arange(h, device=fake_raw.device).reshape(1, h)
    upper, lower = r < x_upper, r >= x_bottom
    idx = torch.where(upper, r + hd2, torch.where(lower, x2 + r - x_bottom, 0)).clamp(0, h - 1)
    rows = torch.gather(real, 1, idx.reshape(b, h, 1, 1).expand(real.shape))
    mid = (~(upper | lower)).reshape(b, h, 1, 1)
    return torch.where(mid, fake_raw, 0) + torch.where(~mid, rows, 0)


def local_crop_mask(h, w, half=35, device="cpu"):
    c = torch.arange(w, device=device)
    m = ((c >= w // 2 - half) & (c < w // 2 + half)).float()
    return m.reshape(1, w).expand(h, w)


# --------------------------------------------------------- contextual attention

def _same_pad(x, k, s):
    h, w = x.shape[1], x.shape[2]
    ph = max(0, (-(-h // s) - 1) * s + k - h)
    pw = max(0, (-(-w // s) - 1) * s + k - w)
    return F.pad(x, (0, 0, pw // 2, pw - pw // 2, ph // 2, ph - ph // 2))


def patches(x, k, s):
    """(B, H, W, C) -> (B, L, k*k*C) SAME patches, (ky, kx, c) inside."""
    xp = _same_pad(x, k, s)
    oh, ow = -(-x.shape[1] // s), -(-x.shape[2] // s)
    cols = [xp[:, dy:dy + (oh - 1) * s + 1:s, dx:dx + (ow - 1) * s + 1:s, :]
            for dy in range(k) for dx in range(k)]
    return torch.cat(cols, dim=-1).reshape(x.shape[0], oh * ow, -1)


def _fuse_diag(y):
    yp = F.pad(y, (1, 1, 1, 1))
    return yp[:, :-2, :-2] + yp[:, 1:-1, 1:-1] + yp[:, 2:, 2:]


def _transposed(y, hd, wd):
    """(B, L, P) scores with both L and P re-indexed in the transposed
    (column-major) flatten of the (hd, wd) grid."""
    b = y.shape[0]
    t = y.reshape(b, hd, wd, hd, wd).permute(0, 2, 1, 4, 3)
    return t.reshape(b, hd * wd, hd * wd)


def fuse(s, hd, wd):
    """The published fuse: a 3x3 identity conv over the score image, then
    the same over its transposed flatten, transposed back."""
    s = _fuse_diag(s)
    return _transposed(_fuse_diag(_transposed(s, hd, wd)), wd, hd)


def contextual_attention(f, mask, scale=10.0, quant=None):
    """f: (B, H, W, C) features (foreground = background), mask (B, 4H, 4W, 1)."""
    bs, h, w, c = f.shape
    hd, wd = h // 2, w // 2
    fd = resize_nearest(f, hd, wd)
    md = resize_nearest(mask, mask.shape[1] // 8, mask.shape[2] // 8)
    mm = (patches(md, 3, 1).mean(dim=2) == 0.0).float()[:, :, None]  # (B, L, 1)
    pat = patches(fd, 3, 1)  # (B, L, 9C): query and key patches alike
    if quant == "int8":
        pat = fake_int8(pat)
    nrm = torch.sqrt(torch.clamp((pat * pat).sum(-1, keepdim=True), min=1e-8))
    s = torch.einsum("blk,bpk->blp", pat, pat) / nrm
    probs = torch.softmax(fuse(s, hd, wd) * mm * scale, dim=1) * mm
    raw = patches(f, 4, 2)  # (B, L, 16C)
    if quant == "int8":
        probs, raw = fake_int8(probs), fake_int8(raw)
    vals = torch.einsum("blp,blk->bpk", probs, raw)  # (B, P, 4 * 4 * C)
    # overlap-add of the 4 x 4 stride-2 patches (the transposed conv), / 4
    cols = vals.reshape(bs, hd * wd, 4, 4, c).permute(0, 4, 2, 3, 1).reshape(bs, c * 16, -1)
    y = F.fold(cols, (h, w), kernel_size=4, stride=2, padding=1) / 4.0
    return _nhwc(y)


# ------------------------------------------------------------------ generator

def _l2(x, eps=1e-12):
    return x / (torch.linalg.vector_norm(x) + eps)


class SNConv(nn.Module):
    """Conv with bias, spectrally normalised by one power iteration from the
    stored u (u and v constants for the gradient)."""

    def __init__(self, fin, fout, k, stride=1, padding=0, dilation=1):
        super().__init__()
        self.stride, self.padding, self.dilation = stride, padding, dilation
        self.weight = nn.Parameter(torch.zeros(fout, fin, k, k))
        self.bias = nn.Parameter(torch.zeros(fout))
        self.register_buffer("u", _l2(torch.ones(fout)))
        self.quant = None

    def normalized_weight(self):
        mat = self.weight.reshape(self.weight.shape[0], -1)
        with torch.no_grad():
            v = _l2(mat.T @ self.u)
            u_new = _l2(mat @ v)
        return self.weight / (u_new @ (mat @ v))

    @torch.no_grad()
    def power_iteration(self):
        mat = self.weight.reshape(self.weight.shape[0], -1)
        self.u.copy_(_l2(mat @ _l2(mat.T @ self.u)))

    def forward(self, x):
        return conv(x, self.normalized_weight(), self.bias, self.stride, self.padding,
                    self.dilation, self.quant)


_ACT = {"elu": F.elu, "relu": F.relu, "sigmoid": torch.sigmoid, "none": lambda x: x}


class Block(nn.Module):
    def __init__(self, fin, fout, k, s, p, r=1, act="elu"):
        super().__init__()
        self.conv = SNConv(fin, fout, k, s, p, r)
        self.act = act

    def forward(self, x):
        return _ACT[self.act](self.conv(x))


_ATROUS = (("conv7_atrous", 2), ("conv8_atrous", 4), ("conv9_atrous", 8), ("conv10_atrous", 16))
_TRUNK = ("conv1", "conv2_downsample", "conv3", "conv4_downsample", "conv5", "conv6",
          "conv7_atrous", "conv8_atrous", "conv9_atrous", "conv10_atrous")


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def _up(z, h, w):
    return _nchw(resize_nearest(_nhwc(z), h, w))


def _ratio_plane(r, h, w):
    return r.reshape(-1, 1, 1, 1).float().expand(r.shape[0], h, w, 1)


class Coarse(nn.Module):
    def __init__(self, c=16):
        super().__init__()
        add = lambda n, *a, **k: self.add_module(n, Block(*a, **k))
        add("conv1", 3, c, 5, 1, 2)
        add("conv2_downsample", c, 2 * c, 3, 2, 1)
        add("conv3", 2 * c, 2 * c, 3, 1, 1)
        add("conv4_downsample", 2 * c, 4 * c, 3, 2, 1)
        add("conv5", 4 * c, 4 * c, 3, 1, 1)
        add("conv6", 4 * c, 4 * c, 3, 1, 1)
        for n, r in _ATROUS:
            add(n, 4 * c, 4 * c, 3, 1, r, r)
        self.fc_height = nn.Linear(4 * c, 1)
        add("conv11", 4 * c, 4 * c, 3, 1, 1)
        add("conv12", 4 * c, 4 * c, 3, 1, 1)
        add("conv20", 4 * c + 1, 4 * c, 3, 1, 1)
        add("conv13", 4 * c, 2 * c, 3, 1, 1)
        add("conv14", 2 * c, 2 * c, 3, 1, 1)
        add("conv19", 2 * c + 1, 2 * c, 3, 1, 1)
        add("conv15", 2 * c, c, 3, 1, 1)
        add("conv16", c, c // 2, 3, 1, 1)
        add("conv17", c // 2, 1, 3, 1, 1, act="none")
        add("conv18", c // 2, 1, 3, 1, 1, act="sigmoid")

    def forward(self, x, mask, cam, ratio):
        h, w = x.shape[1], x.shape[2]
        z = _nchw(torch.cat([x, _ratio_plane(ratio, h, w), mask], -1))
        for n in _TRUNK:
            z = getattr(self, n)(z)
        pred_h = torch.sigmoid(self.fc_height(z.mean(dim=(2, 3))))[:, 0]
        z = _up(self.conv12(self.conv11(z)), h // 2, w // 2)
        z = self.conv20(torch.cat([z, _nchw(resize_nearest(cam, h // 2, w // 2))], 1))
        z = _up(self.conv14(self.conv13(z)), h, w)
        z = self.conv19(torch.cat([z, _nchw(cam)], 1))
        z = self.conv16(self.conv15(z))
        return _nhwc(self.conv18(z)), _nhwc(torch.clamp(self.conv17(z), -1.0, 1.0)), pred_h


class Fine(nn.Module):
    def __init__(self, c=16):
        super().__init__()
        add = lambda n, *a, **k: self.add_module(n, Block(*a, **k))
        add("conv1", 4, c, 5, 1, 2)
        add("conv2_downsample", c, c, 3, 2, 1)
        add("conv3", c, 2 * c, 3, 1, 1)
        add("conv4_downsample", 2 * c, 2 * c, 3, 2, 1)
        add("conv5", 2 * c, 4 * c, 3, 1, 1)
        add("conv6", 4 * c, 4 * c, 3, 1, 1)
        for n, r in _ATROUS:
            add(n, 4 * c, 4 * c, 3, 1, r, r)
        add("pmconv1", 4, c, 5, 1, 2)
        add("pmconv2_downsample", c, c, 3, 2, 1)
        add("pmconv3", c, 2 * c, 3, 1, 1)
        add("pmconv4_downsample", 2 * c, 4 * c, 3, 2, 1)
        add("pmconv5", 4 * c, 4 * c, 3, 1, 1)
        add("pmconv6", 4 * c, 4 * c, 3, 1, 1, act="relu")
        add("pmconv9", 4 * c, 4 * c, 3, 1, 1)
        add("pmconv10", 4 * c, 4 * c, 3, 1, 1)
        add("allconv11", 8 * c, 4 * c, 3, 1, 1)
        self.fc_height = nn.Linear(4 * c, 1)
        add("allconv12", 4 * c, 4 * c, 3, 1, 1)
        add("allconv19", 4 * c, 4 * c, 3, 1, 1)
        add("allconv13", 4 * c, 2 * c, 3, 1, 1)
        add("allconv14", 2 * c, 2 * c, 3, 1, 1)
        add("allconv15", 2 * c, c, 3, 1, 1)
        add("allconv16", c, c // 2, 3, 1, 1)
        add("allconv17", c // 2 + 1, 1, 3, 1, 1, act="none")
        add("allconv18", c // 2 + 1, 1, 3, 1, 1, act="sigmoid")
        self.quant = None

    def forward(self, x, x1, mask, coarse_seg, ratio):
        h, w = x.shape[1], x.shape[2]
        xnow = _nchw(torch.cat([x, coarse_seg, mask, _ratio_plane(ratio, h, w)], -1))
        z = xnow
        for n in _TRUNK:
            z = getattr(self, n)(z)
        a = xnow
        for n in ("pmconv1", "pmconv2_downsample", "pmconv3", "pmconv4_downsample",
                  "pmconv5", "pmconv6"):
            a = getattr(self, n)(a)
        y = contextual_attention(_nhwc(a), mask, 10.0, self.quant)
        pm = self.pmconv10(self.pmconv9(_nchw(y)))
        z = self.allconv11(torch.cat([z, pm], 1))
        pred_h = torch.sigmoid(self.fc_height(z.mean(dim=(2, 3))))[:, 0]
        z = _up(self.allconv19(self.allconv12(z)), h // 2, w // 2)
        z = _up(self.allconv14(self.allconv13(z)), h, w)
        z = torch.cat([self.allconv16(self.allconv15(z)), _nchw(x1)], 1)
        return (_nhwc(self.allconv18(z)), _nhwc(torch.clamp(self.allconv17(z), -1.0, 1.0)),
                pred_h)


class GenOut(NamedTuple):
    coarse_seg: torch.Tensor
    fine_seg: torch.Tensor
    x_stage1: torch.Tensor
    x_stage2: torch.Tensor
    pred1_h: torch.Tensor  # sigmoid fraction of MAXHEIGHT
    pred2_h: torch.Tensor


class Generator(nn.Module):
    def __init__(self, cnum=16, quant=None):
        super().__init__()
        self.coarse_generator = Coarse(cnum)
        self.fine_generator = Fine(cnum)
        self.set_quant(quant)

    def set_quant(self, quant):
        self.fine_generator.quant = quant
        for m in self.modules():
            if isinstance(m, SNConv):
                m.quant = quant

    def forward(self, x, mask, cam, ratio) -> GenOut:
        cseg, x1, p1 = self.coarse_generator(x, mask, cam, ratio)
        fseg, x2, p2 = self.fine_generator(x, x1, mask, cseg, ratio)
        return GenOut(cseg, fseg, x1, x2, p1, p2)


def npz_state_dict(path) -> Dict[str, torch.Tensor]:
    """The generator's weights from an exported flax ``.npz`` (kernels HWIO,
    dense kernels (in, out), spectral-norm vectors under ``sn/``)."""
    import numpy as np

    sd = {}
    with np.load(path) as z:
        for key in z.files:
            tree, *mod, name = key.split("/")
            a = np.asarray(z[key], np.float32)
            if name == "kernel":
                a = a.transpose(3, 2, 0, 1) if a.ndim == 4 else a.T
                name = "weight"
            sd[".".join(mod + [name])] = torch.from_numpy(np.ascontiguousarray(a))
    return sd


# ------------------------------------------------------------- discriminators

class BatchNorm(nn.Module):
    """Batch statistics in the forward; running statistics updated as
    r = 0.9 r + 0.1 batch with the biased variance."""

    def __init__(self, n):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(n))
        self.bias = nn.Parameter(torch.zeros(n))
        self.register_buffer("running_mean", torch.zeros(n))
        self.register_buffer("running_var", torch.ones(n))

    def forward(self, x, update_stats=True):
        var, mean = torch.var_mean(x, dim=(0, 2, 3), unbiased=False)
        if update_stats:
            with torch.no_grad():
                self.running_mean.mul_(0.9).add_(0.1 * mean)
                self.running_var.mul_(0.9).add_(0.1 * var)
        y = (x - mean[None, :, None, None]) * torch.rsqrt(var + 1e-5)[None, :, None, None]
        return y * self.weight[None, :, None, None] + self.bias[None, :, None, None]


class NLayerD(nn.Module):
    """The 70 x 70 PatchGAN with n_layers = 3 and BatchNorm."""

    def __init__(self, ndf=64, n_layers=3):
        super().__init__()
        self.n_layers = n_layers
        self.conv0 = nn.Conv2d(1, ndf, 4, 2, 1)
        prev = 1
        for n in range(1, n_layers):
            nf = min(2 ** n, 8)
            self.add_module(f"conv{n}", nn.Conv2d(ndf * prev, ndf * nf, 4, 2, 1, bias=False))
            self.add_module(f"norm{n}", BatchNorm(ndf * nf))
            prev = nf
        nf = min(2 ** n_layers, 8)
        self.add_module(f"conv{n_layers}", nn.Conv2d(ndf * prev, ndf * nf, 4, 1, 1, bias=False))
        self.add_module(f"norm{n_layers}", BatchNorm(ndf * nf))
        self.conv_out = nn.Conv2d(ndf * nf, 1, 4, 1, 1)
        self.quant = None

    def _c(self, name, x):
        m = getattr(self, name)
        return conv(x, m.weight, m.bias, m.stride, m.padding, 1, self.quant)

    def forward(self, x, update_stats=True):
        h = F.leaky_relu(self._c("conv0", _nchw(x)), 0.2)
        for n in range(1, self.n_layers + 1):
            h = F.leaky_relu(getattr(self, f"norm{n}")(self._c(f"conv{n}", h), update_stats), 0.2)
        return _nhwc(self._c("conv_out", h))


def gan_loss(logits, real: bool):
    """Vanilla GAN loss: BCE with logits against a constant label."""
    return torch.mean(F.softplus(logits) - (1.0 if real else 0.0) * logits)


# ------------------------------------------------------------------ training

class Nets(nn.Module):
    """The generator and three discriminators, with the state-dict keys
    ``gen.``, ``d1.``, ``d2.``, ``d3.``."""

    def __init__(self, ngf=16, ndf=64, n_layers_d=3, quant=None):
        super().__init__()
        self.gen = Generator(ngf, quant)
        self.d1, self.d2, self.d3 = (NLayerD(ndf, n_layers_d) for _ in range(3))
        for d in (self.d1, self.d2, self.d3):
            d.quant = quant


def generator_outputs(gen, batch, image_size):
    """fake_b, fake_b_coarse (SHRM-pasted), the seg maps and the heights."""
    out = gen(batch["context"], batch["mask"], 1.0 - batch["cam"], batch["slice_ratio"])
    p1, p2 = out.pred1_h * MAXHEIGHT, out.pred2_h * MAXHEIGHT
    geo = (batch["height"], batch["x1"], batch["x2"])
    fake_b = shrm_paste(out.x_stage2, batch["full"], p2.detach(), *geo)
    fake_bc = shrm_paste(out.x_stage1, batch["full"], p1.detach(), *geo)
    return fake_b, fake_bc, out.coarse_seg, out.fine_seg, p1, p2


def train_step(nets: Nets, opts, batch, lr, cfg):
    """One step of the upstream's order: D1, D2, D3, then G. opts: the Adam
    optimizers of gen, d1, d2, d3. Returns the losses (0-d tensors)."""
    gen, discs = nets.gen, (nets.d1, nets.d2, nets.d3)
    for o in opts:
        for g in o.param_groups:
            g["lr"] = float(lr)
    s = cfg["image_size"]
    full, mask = batch["full"], batch["mask"]
    gen.zero_grad(set_to_none=True)
    fake_b, fake_bc, cseg, fseg, p1, p2 = generator_outputs(gen, batch, s)
    seg_bin = (fseg > 0.5).float()
    center = local_crop_mask(s, s, device=full.device)[None, :, :, None]
    losses = {}
    pairs = ((fake_b, full), (seg_bin, batch["vert_seg"]),
             (mask * fake_b * center, mask * full * center))
    for i, (d, opt, (fake, real)) in enumerate(zip(discs, opts[1:], pairs), start=1):
        opt.zero_grad(set_to_none=True)
        l_fake = gan_loss(d(fake.detach()), False)
        l_real = gan_loss(d(real), True)
        ((l_fake + l_real) * 0.5).backward()
        opt.step()
        losses[f"D_fake_{i}"], losses[f"D_real_{i}"] = l_fake.detach(), l_real.detach()
    params = [p for d in discs for p in d.parameters()]
    for p in params:
        p.requires_grad_(False)
    heads = (fake_b, seg_bin, mask * fake_b * center)
    l_gan = sum(gan_loss(d(x, update_stats=False), True) for d, x in zip(discs, heads)) / 6.0
    for p in params:
        p.requires_grad_(True)
    count = torch.clamp(torch.count_nonzero(mask).float(), min=1.0)
    l_l1 = ((fake_b - full).abs().mean() + (fake_bc - full).abs().mean()) * 0.5 \
        * cfg["lambda_L1"] * (s * s / count) * 2.0
    l_cd = (1.0 - dice_coeff(cseg, batch["normal_vert"])) * 10.0
    l_dice = (1.0 - dice_coeff(fseg, batch["vert_seg"])) * 15.0
    l_edge = torch.mean((sobel_edges(seg_bin) - sobel_edges(batch["vert_seg"])) ** 2) * 800.0
    h = batch["height"].float()
    l_h = torch.mean((p1 - h).abs() / h * 40.0 + (p2 - h).abs() / h * 40.0)
    total = l_gan + l_l1 + l_dice + l_edge + l_cd + l_h
    total.backward()
    for m in gen.modules():
        if isinstance(m, SNConv):
            m.power_iteration()
    opts[0].step()
    losses.update(G_GAN=l_gan.detach(), G_maskL1=l_l1.detach(), G_Dice=l_dice.detach(),
                  coarse_Dice=l_cd.detach(), edge=l_edge.detach(), h=l_h.detach(),
                  G_total=total.detach())
    return losses
