"""The HealthiVert-GAN training step and the generator's serving forward.

Counterpart of healthivert_tpu/models/pix2pix.py: `Pix2PixConfig` (:46-125),
`build_modules` (:145-176), `make_optimizer` (:179-182), `init_state`
(:185-212), `generator_forward` (:215-282), `_update_sn_tree` (:386-405),
`train_step` (:408-606), the learning-rate schedule (:609-681) and the int8
calibration (`INT8_CALIB_PERCENTILE`, `calib_to_quant`, `merge_calib`,
`calibrate_int8`, :285-373). The JAX `_d_forward` (:375-383) is
`_d_logits` here: the discriminators' own forward, whose `update_stats` flag
stands for the mutable batch_stats collection; of the seg discriminator
(--netD seg, models/legacy.py) it takes the patch logits alone.

Under a process group of several ranks (parallel/distributed.py) each rank
holds its slice of the global batch and the step equals the JAX step on the
whole batch sharded over a `data` mesh: the discriminators' BatchNorm takes
global statistics, the masked L1 divides by the global mask count, every
gradient is averaged over the ranks before its optimizer step, and the
returned losses are the means over the ranks, the same on every rank.

int8 is an inference mode of the generator (the discriminators run bf16;
training refuses it). Its calibration statistics and static scales are flat
dicts keyed by the module path of the conv (``fine_generator.conv1.conv``):
a calib tree maps it to {"act_absmax": 0-d, "act_pq": (4,)} float32
tensors, a quant tree to its 0-d float32 activation scale.

Loss surface, as in the JAX package (reference pix2pix_model.py:331-353):
  G_GAN   = (gan(D1(fake)) + gan(D2(fake_seg)) + gan(D3(fake_local))) / 6
  maskL1  = (L1(fake, real) + L1(fake_coarse, real)) * .5 * lambda_L1
            * (W * W / count_nonzero(mask)) * 2
  coarse_Dice = (1 - dice(coarse_seg, normal_vert)) * 10
  G_Dice  = (1 - dice(fine_seg, vert_seg)) * 15
  edge    = mse(sobel(binarized fine_seg), sobel(vert_seg)) * 800
  h       = mean(|pred1_h - h| / h * 40 + |pred2_h - h| / h * 40)
D2's GAN term and the edge term pass a hard 0.5 threshold, so they give the
generator no gradient (as in the reference); they are still logged.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Dict

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from ..ops import geometry as geo
from ..parallel import distributed
from ..ops.image import dice_coeff, sobel_edges
from ..utils.device import resolve_device
from ..utils.weights import load_npz_state_dict
from .discriminator import NLayerDiscriminator, PixelDiscriminator, gan_loss
from .generator import Generator, init_generator
from .legacy import SegDiscriminator
from .layers import CALIB_PERCENTILES, INT8, SNConv, int8_scope

_DTYPES = {"float32": None, "bfloat16": torch.bfloat16, "int8": INT8}


@dataclasses.dataclass(frozen=True)
class Pix2PixConfig:
    """Static training and serving config, with the JAX package's fields and
    defaults. ngf=16: the reference hard-codes the generator width to 16.

    gan_head_preupdate (default on, as in the JAX package): the generator's
    GAN terms read the discriminators as they were before this step's
    updates (a simultaneous update) instead of after them (the reference's
    alternating one); equal to False at lr=0. crop_d3 (default on): D3 sees
    a 48 x 128 crop that holds every non-zero pixel of its input instead of
    the full frame."""

    ngf: int = 16
    ndf: int = 64
    net_d: str = "basic"  # basic | n_layers | pixel | seg
    n_layers_d: int = 3  # read when net_d is "n_layers" or "seg"
    norm: str = "batch"  # batch | instance | none (discriminator norm layers)
    lr: float = 2e-4
    beta1: float = 0.5
    lambda_l1: float = 200.0
    gan_mode: str = "vanilla"  # vanilla | lsgan | wgangp
    init_type: str = "normal"  # normal | xavier | kaiming | orthogonal (discriminators)
    init_gain: float = 0.02
    maxheight: float = 40.0
    image_size: int = 256
    compute_dtype: str = "float32"  # float32 | bfloat16 | int8; parameters stay
    # float32; int8 = post-training-quantized generator convs, inference only
    compute_offsets: bool = False  # attention argmax offsets (flow viz)
    # the JAX package's stacked, vmapped D1-D3 updates: a layout switch that
    # runs here as the three sequential updates (PyTorch has no grouped-conv
    # lowering to choose); it needs inputs of one shape, so not crop_d3
    vmap_discriminators: bool = False
    remat: bool = False  # recompute the generator forward in the backward
    gan_head_preupdate: bool = True
    crop_d3: bool = True

    def __post_init__(self):
        if self.compute_dtype not in _DTYPES:
            raise NotImplementedError(
                f"compute_dtype={self.compute_dtype!r}: the port runs "
                f"{sorted(_DTYPES)}"
            )

    @property
    def module_dtype(self):
        """Conv dtype of the generator: None (follow the input), bf16 or
        "int8"."""
        return _DTYPES[self.compute_dtype]

    @property
    def disc_dtype(self):
        """Conv dtype of the discriminators, which never run int8."""
        return torch.bfloat16 if self.compute_dtype == "int8" else self.module_dtype


def build_generator(cfg: Pix2PixConfig) -> Generator:
    return Generator(cnum=cfg.ngf, dtype=cfg.module_dtype,
                     compute_offsets=cfg.compute_offsets)


def build_discriminator(cfg: Pix2PixConfig) -> nn.Module:
    """define_D's dispatch (reference networks.py:163-209)."""
    if cfg.net_d == "basic":
        return NLayerDiscriminator(1, cfg.ndf, 3, cfg.norm, cfg.disc_dtype)
    if cfg.net_d == "n_layers":
        return NLayerDiscriminator(1, cfg.ndf, cfg.n_layers_d, cfg.norm, cfg.disc_dtype)
    if cfg.net_d == "pixel":
        return PixelDiscriminator(1, cfg.ndf, cfg.norm, cfg.disc_dtype)
    if cfg.net_d == "seg":
        # float32 whatever compute_dtype, and no norm choice: the JAX module
        # takes neither (its pix2pix.py:170-173)
        return SegDiscriminator(1, cfg.ndf, cfg.n_layers_d, cfg.init_type, cfg.init_gain)
    raise NotImplementedError(f"Discriminator model name [{cfg.net_d}] is not recognized")


def build_modules(cfg: Pix2PixConfig):
    """(generator, (D1, D2, D3)): three discriminators of one architecture,
    each with its own weights (reference pix2pix_model.py:114-119)."""
    return build_generator(cfg), tuple(build_discriminator(cfg) for _ in range(3))


def make_optimizer(params, cfg: Pix2PixConfig) -> torch.optim.Adam:
    """torch.optim.Adam(lr, betas=(beta1, 0.999)): the update of
    optax.scale_by_adam followed by -lr. train_step sets lr on every step."""
    return torch.optim.Adam(params, lr=cfg.lr, betas=(cfg.beta1, 0.999), eps=1e-8)


@dataclasses.dataclass
class TrainState:
    """The networks and their optimizers; train_step updates them in place.
    BatchNorm running statistics live in the discriminators' buffers and the
    spectral-norm vectors in the generator's."""

    step: int
    gen: Generator
    d1: nn.Module
    d2: nn.Module
    d3: nn.Module
    opt_g: torch.optim.Adam
    opt_d1: torch.optim.Adam
    opt_d2: torch.optim.Adam
    opt_d3: torch.optim.Adam


def init_state(cfg: Pix2PixConfig, seed: int = 0, device="cuda",
               gen_npz=None) -> TrainState:
    """Networks initialised from `seed` (a CPU torch.Generator, so the draw
    is the same on every device), or the generator from an exported
    ``.npz``; moved to `device`, with fresh Adam states."""
    dev = resolve_device(device)
    gen, discs = build_modules(cfg)
    rng = torch.Generator().manual_seed(seed)
    if gen_npz is not None:
        gen.load_state_dict(load_npz_state_dict(gen_npz))
    else:
        init_generator(gen, rng)
    for d in discs:
        d.init_weights(rng, cfg.init_type, cfg.init_gain)
    gen.to(dev).train()
    for d in discs:
        d.to(dev).train()
    opts = [make_optimizer(m.parameters(), cfg) for m in (gen, *discs)]
    return TrainState(0, gen, *discs, *opts)


def _low_precision_inputs(batch, cfg: Pix2PixConfig):
    """Under bf16 and int8 the 4-D float32 inputs enter as bf16."""
    if cfg.compute_dtype not in ("bfloat16", "int8"):
        return batch
    return {k: (v.to(torch.bfloat16) if v.dtype == torch.float32 and v.dim() == 4 else v)
            for k, v in batch.items()}


def quant_scales(gen: Generator, g_quant):
    """{SNConv: scale on its device} of a quant tree (None stays None);
    raises KeyError for a path that names no conv of `gen`."""
    if g_quant is None:
        return None
    convs = {name: m for name, m in gen.named_modules() if isinstance(m, SNConv)}
    unknown = sorted(set(g_quant) - set(convs))
    if unknown:
        raise KeyError(f"quant tree names no conv of the generator: {unknown[:3]}")
    return {convs[k]: v.to(convs[k].weight.device) for k, v in g_quant.items()}


def generator_forward(gen: Generator, batch: Dict[str, torch.Tensor],
                      cfg: Pix2PixConfig, update_sn: bool = False, g_quant=None):
    """Full forward including SHRM paste-back.

    batch: NHWC tensors context, mask, cam, full, vert_seg (B, H, W, 1) and
    (B,) slice_ratio, height, x1, x2, all on the generator's device.
    g_quant: a quant tree (calibrate_int8) whose static activation scales
    the int8 convs use in this call; without it they take per-sample
    dynamic scales. Returns the JAX function's dict without `new_sn`: a
    forward never updates u (training advances it with `_update_sn_tree`)."""
    if update_sn:
        raise NotImplementedError(
            "update_sn=True is not ported: train_step advances u with _update_sn_tree"
        )
    batch = _low_precision_inputs(batch, cfg)
    cam_inv = 1.0 - batch["cam"]
    with int8_scope(scales=quant_scales(gen, g_quant)):
        out = gen(batch["context"], batch["mask"], cam_inv, batch["slice_ratio"])
    pred1_h = out.pred1_h * cfg.maxheight
    pred2_h = out.pred2_h * cfg.maxheight

    height, x1, x2 = batch["height"], batch["x1"], batch["x2"]
    full = batch["full"]
    fake_b = geo.shrm_paste_batch(out.x_stage2, full, pred2_h, height, x1, x2)
    fake_b_coarse = geo.shrm_paste_batch(out.x_stage1, full, pred1_h, height, x1, x2)

    fine_seg_bin = (out.fine_seg > 0.5).to(out.fine_seg.dtype)
    coarse_seg_bin = (out.coarse_seg > 0.5).to(out.coarse_seg.dtype)

    s = cfg.image_size
    center = geo.local_crop_mask(s, s, device=full.device)[None, :, :, None]
    fake_local = batch["mask"] * fake_b * center
    real_local = batch["mask"] * full * center

    return dict(
        gen=out,
        pred1_h=pred1_h,
        pred2_h=pred2_h,
        fake_b=fake_b,
        fake_b_coarse=fake_b_coarse,
        fine_seg_bin=fine_seg_bin,
        coarse_seg_bin=coarse_seg_bin,
        fake_local=fake_local,
        real_local=real_local,
        fake_edges=sobel_edges(fine_seg_bin),
        real_edges=sobel_edges(batch["vert_seg"]),
    )


# The default calibration percentile of the "auto" static int8 scales: the
# JAX package's sweep on the shipped checkpoint found 99.5 the balanced
# point between SSIM, PSNR and IoU (its pix2pix.py:285-291).
INT8_CALIB_PERCENTILE = 99.5


def calib_to_quant(calib, percentile=None):
    """Quant tree of a calib tree: act_scale = max(stat, 1e-12) / 127, the
    stat being act_absmax or, with `percentile` (one of CALIB_PERCENTILES),
    that entry of act_pq."""
    if percentile is not None and percentile not in CALIB_PERCENTILES:
        raise ValueError(
            f"percentile must be one of {CALIB_PERCENTILES} (the act_pq "
            f"calibration grid), got {percentile}")
    pick = ((lambda s: s["act_absmax"]) if percentile is None else
            (lambda s: s["act_pq"][CALIB_PERCENTILES.index(percentile)]))
    return {k: pick(s).float().clamp_min(1e-12) / 127.0 for k, s in calib.items()}


def merge_calib(a, b):
    """Elementwise max of two calib trees (calibration over several batches)."""
    if a is None:
        return b
    return {k: {s: torch.maximum(a[k][s], b[k][s]) for s in a[k]} for k in a}


@torch.no_grad()
def calibrate_one(gen: Generator, context, mask, cam_inv, slice_ratio):
    """Calib tree of one int8 generator forward at dynamic scales."""
    stats = {}
    with int8_scope(calib=stats):
        gen(context, mask, cam_inv, slice_ratio)
    names = {m: name for name, m in gen.named_modules()}
    return {names[m]: s for m, s in stats.items()}


def calibrate_int8(gen: Generator, batches, cfg: Pix2PixConfig, percentile=None,
                   return_calib=False):
    """Static per-tensor int8 activation scales from generator_forward-style
    batches: each int8 conv records its input's |x| max and quantiles while
    the generator runs at dynamic scales; the trees of the batches are
    max-merged. Returns the quant tree for generator_forward(g_quant=), or
    with return_calib=True the merged calib tree (one pass then serves any
    percentile through calib_to_quant)."""
    calib = None
    for batch in batches:
        b = _low_precision_inputs(batch, cfg)
        calib = merge_calib(calib, calibrate_one(gen, b["context"], b["mask"],
                                                 1.0 - b["cam"], b["slice_ratio"]))
    if calib is None:
        raise ValueError("calibrate_int8 needs at least one batch")
    if return_calib:
        return calib
    return calib_to_quant(calib, percentile=percentile)


@torch.no_grad()
def _update_sn_tree(gen: Generator):
    """One power iteration on every stored u vector, from the weights alone."""
    for m in gen.modules():
        if isinstance(m, SNConv):
            m.power_iteration()


@contextlib.contextmanager
def _frozen(modules):
    """Parameters of `modules` stop requiring grad for the duration: their
    forwards then pass gradients to their inputs only."""
    params = [p for m in modules for p in m.parameters()]
    flags = [p.requires_grad for p in params]
    for p in params:
        p.requires_grad_(False)
    try:
        yield
    finally:
        for p, flag in zip(params, flags):
            p.requires_grad_(flag)


def _d_logits(d: nn.Module, x, update_stats: bool = True):
    """A discriminator's patch logits (the JAX `_d_forward`): the seg
    discriminator's seg map is dropped, its decoder run only for its
    running statistics (`SegDiscriminator`, seg=False)."""
    if isinstance(d, SegDiscriminator):
        return d(x, update_stats, seg=False)
    return d(x, update_stats)


def _zero_missing_grads(module: nn.Module):
    """Zero .grad for the parameters no loss reached (the seg decoder's),
    as jax.grad gives them: Adam then steps them by exactly 0 and keeps
    moments for them, as optax does."""
    for p in module.parameters():
        if p.grad is None:
            p.grad = torch.zeros_like(p)


def train_step(state: TrainState, batch: Dict[str, torch.Tensor], lr: float,
               cfg: Pix2PixConfig = Pix2PixConfig()):
    """One optimization step: D1, D2, D3, then G, as in the JAX package.
    Updates `state` in place and returns (state, losses), the losses as 0-d
    float32 tensors on the device. Afterwards every parameter's .grad holds
    this step's gradient.

    The generator runs once; its GAN terms read the discriminators with
    their parameters frozen and without a running-statistics update. With
    gan_head_preupdate that happens before the discriminator updates (so
    its graph is freed early); otherwise after them. The fakes reach the
    discriminator updates detached, and each discriminator sees its fake
    batch and then its real batch in two forwards (BatchNorm statistics are
    per forward). u advances from the pre-update generator weights.

    remat wraps the generator forward in a non-reentrant activation
    checkpoint: the backward runs it again instead of keeping its
    activations."""
    if cfg.crop_d3 and cfg.vmap_discriminators:
        raise ValueError("crop_d3 is incompatible with vmap_discriminators "
                         "(the three D inputs no longer share shapes)")
    gen, discs = state.gen, (state.d1, state.d2, state.d3)
    opts_d = (state.opt_d1, state.opt_d2, state.opt_d3)
    for opt in (state.opt_g, *opts_d):
        for group in opt.param_groups:
            group["lr"] = float(lr)
    full, mask = batch["full"], batch["mask"]
    s = cfg.image_size
    losses = {}

    gen.zero_grad(set_to_none=True)

    def g_outputs():
        f = generator_forward(gen, batch, cfg)
        return (f["fake_b"], f["fake_b_coarse"], f["gen"].coarse_seg, f["gen"].fine_seg,
                f["pred1_h"], f["pred2_h"])

    outs = checkpoint(g_outputs, use_reentrant=False) if cfg.remat else g_outputs()
    fake_b, fine_seg = outs[0], outs[3]

    fine_seg_bin = (fine_seg > 0.5).to(fine_seg.dtype)
    center = geo.local_crop_mask(s, s, device=full.device)[None, :, :, None]
    fake_local = mask * fake_b * center
    real_local = mask * full * center
    crop = lambda x: x
    if cfg.crop_d3:
        crop = lambda x: geo.band_crop_batch(x, mask, min(48, s), min(128, s))
        fake_local, real_local = crop(fake_local), crop(real_local)
    real_edges = sobel_edges(batch["vert_seg"])

    def g_loss_head():
        # reductions in float32 whatever the compute dtype
        fb, fbc, cs, fs, p1h, p2h = (o.float() for o in outs)
        seg_bin = (fs > 0.5).float()
        with _frozen(discs):
            heads = (fb, seg_bin, crop(mask * fb * center))
            l_gan = sum(gan_loss(_d_logits(d, x, update_stats=False), True, cfg.gan_mode)
                        for d, x in zip(discs, heads)) / 6.0
        # the global batch's count: each rank's mean L1 then averages to it.
        # Under a model axis each data shard sits on replicas() ranks, so the
        # sum over the ranks counts every shard that many times
        mask_count = distributed.all_reduce_sum(
            torch.count_nonzero(mask).float()) / distributed.replicas()
        l_l1 = (
            (torch.mean(torch.abs(fb - full)) + torch.mean(torch.abs(fbc - full)))
            * 0.5
            * cfg.lambda_l1
            * (s * s / torch.clamp(mask_count, min=1.0))
            * 2.0
        )
        l_coarse_dice = (1.0 - dice_coeff(cs, batch["normal_vert"])) * 10.0
        l_dice = (1.0 - dice_coeff(fs, batch["vert_seg"])) * 15.0
        l_edge = torch.mean((sobel_edges(seg_bin) - real_edges) ** 2) * 800.0
        h = batch["height"].float()
        l_h = torch.mean(torch.abs(p1h - h) / h * 40.0 + torch.abs(p2h - h) / h * 40.0)
        total = l_gan + l_l1 + l_dice + l_edge + l_coarse_dice + l_h
        total.backward()
        return total, dict(G_GAN=l_gan, G_maskL1=l_l1, G_Dice=l_dice,
                           coarse_Dice=l_coarse_dice, edge=l_edge, h=l_h)

    if cfg.gan_head_preupdate:
        g_total, g_losses = g_loss_head()

    pairs = ((fake_b, full), (fine_seg_bin, batch["vert_seg"]), (fake_local, real_local))
    for i, (d, opt, (fake, real)) in enumerate(zip(discs, opts_d, pairs), start=1):
        opt.zero_grad(set_to_none=True)
        l_fake = gan_loss(_d_logits(d, fake.detach()), False, cfg.gan_mode)
        l_real = gan_loss(_d_logits(d, real), True, cfg.gan_mode)
        ((l_fake + l_real) * 0.5).backward()
        _zero_missing_grads(d)
        distributed.average_gradients(d)
        opt.step()
        losses[f"D_fake_{i}"], losses[f"D_real_{i}"] = l_fake.detach(), l_real.detach()

    if not cfg.gan_head_preupdate:
        g_total, g_losses = g_loss_head()

    _update_sn_tree(gen)  # from the weights before G's update
    distributed.average_gradients(gen)
    state.opt_g.step()
    losses.update({k: v.detach() for k, v in g_losses.items()})
    losses["G_total"] = g_total.detach()
    if distributed.is_multiprocess():
        # one all_reduce: every rank returns the global losses, so that a
        # non-finite loss stops all ranks at the same step
        mean = distributed.all_reduce_mean(torch.stack(list(losses.values())))
        losses = dict(zip(losses, mean.unbind()))
    state.step += 1
    return state, losses


def linear_lr_scale(epoch: int, epoch_count: int, n_epochs: int, n_epochs_decay: int) -> float:
    """networks.py:52-56: constant for n_epochs, then linear decay to zero."""
    return 1.0 - max(0, epoch + epoch_count - n_epochs) / float(n_epochs_decay + 1)


class LRSchedule:
    """Epoch-level learning-rate multiplier, a copy of the JAX package's
    (get_scheduler parity, reference networks.py:39-65): linear | step |
    plateau | cosine. scale() takes the absolute epoch; step and cosine are
    functions of it, and linear converts back to the per-launch counter of
    the reference's LambdaLR, so a resumed run continues the fresh run's
    schedule."""

    def __init__(self, opt):
        self.policy = getattr(opt, "lr_policy", "linear")
        self.opt = opt
        # ReduceLROnPlateau state (torch defaults: best=inf for mode=min,
        # cooldown=0, eps=1e-8, min_lr=0)
        self._plateau_best = float("inf")
        self._plateau_bad = 0
        self._plateau_cooldown = 0
        self._plateau_lr = float(getattr(opt, "lr", 2e-4))

    def scale(self, epoch: int, metric: float | None = None) -> float:
        o = self.opt
        if self.policy == "linear":
            rel = epoch - o.epoch_count + 1
            return linear_lr_scale(rel, o.epoch_count, o.n_epochs, o.n_epochs_decay)
        if self.policy == "step":
            return 0.1 ** (epoch // o.lr_decay_iters)
        if self.policy == "cosine":
            return 0.5 * (1.0 + math.cos(math.pi * epoch / o.n_epochs))
        if self.policy == "plateau":
            # ReduceLROnPlateau(mode='min', factor=0.2, threshold=0.01,
            # patience=5) as torch's step() runs it (networks.py:57-58)
            if metric is not None:
                metric = float(metric)
                if metric < self._plateau_best * (1 - 0.01):
                    self._plateau_best = metric
                    self._plateau_bad = 0
                else:
                    self._plateau_bad += 1
                if self._plateau_cooldown > 0:
                    self._plateau_cooldown -= 1
                    self._plateau_bad = 0
                if self._plateau_bad > 5:
                    new_lr = max(self._plateau_lr * 0.2, 0.0)
                    if self._plateau_lr - new_lr > 1e-8:
                        self._plateau_lr = new_lr
                    self._plateau_cooldown = 0
                    self._plateau_bad = 0
            return self._plateau_lr / float(getattr(self.opt, "lr", 2e-4))
        raise NotImplementedError(f"learning rate policy [{self.policy}]")


def option_setter(parser, is_train):
    """pix2pix's flag defaults (healthivert_tpu/models/pix2pix.py:686-694,
    reference pix2pix_model.py:65-72): batchnorm discriminators, the
    unet_256 netG name (cosmetic: G is the inpainting generator), the
    aligned dataset; and, when training, no image pool, the vanilla GAN
    loss and --lambda_L1."""
    parser.set_defaults(norm="batch", netG="unet_256", dataset_mode="aligned")
    if is_train:
        parser.set_defaults(pool_size=0, gan_mode="vanilla")
        parser.add_argument("--lambda_L1", type=float, default=200.0)
    return parser
