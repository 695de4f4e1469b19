"""In-training evaluation: masked SSIM/PSNR, coarse Dice, fine IoU, height
error, and the eval PNG grid.

Counterpart of healthivert_tpu/engine/evaluate.py:23-129 (parity with the
reference train.py:50-160) on one device: one batched generator forward per
eval batch, per-sample metrics on the device, and only the sums leave it.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch

from ..data.prefetch import to_device
from ..models.generator import Generator
from ..models.pix2pix import Pix2PixConfig, generator_forward
from ..ops import image as I
from .visualizer import write_png


@torch.no_grad()
def eval_batch(gen: Generator, batch: Dict[str, torch.Tensor], cfg: Pix2PixConfig):
    """Per-sample metrics for one batch on the generator's device. Returns
    ({ssim, psnr, dice, iou, diff_h} each (B,), the forward's dict)."""
    f = generator_forward(gen, batch, cfg)
    full = batch["full"].float()
    mask = batch["mask"].float()
    fake = f["fake_b"].float()
    b = fake.shape[0]
    flat = lambda x: x.reshape(b, -1)
    gm = (full * mask)[..., 0]
    fm = (fake * mask)[..., 0]
    # reference data_range choices (train.py:122-125)
    dr_ssim = flat(fake).amax(1) - flat(fake).amin(1)
    dr_psnr = flat(fake).amax(1) - flat(full).amin(1)
    s = I.ssim(gm, fm, data_range=dr_ssim)
    p = I.psnr(gm, fm, data_range=dr_psnr)
    per = lambda fn, x, y: torch.stack([fn(x[i], y[i]) for i in range(b)])
    d = per(I.dice_score, f["coarse_seg_bin"].float(), batch["normal_vert"].float())
    iou = per(I.iou_score, f["fine_seg_bin"].float(), batch["vert_seg"].float())
    h = batch["height"].float()
    dh = torch.abs(f["pred2_h"].float() - h) / h * 100.0
    return dict(ssim=s, psnr=p, dice=d, iou=iou, diff_h=dh), f


def evaluate_model(gen: Generator, dataset, cfg: Pix2PixConfig, out_dir=None, epoch=0):
    """Average metrics over the eval dataset; optionally save a PNG grid of
    [context, fake, real, coarse_seg, normal, fine_seg, vert_seg, cam] rows
    (train.py:150-159). Each batch is evaluated at the size the dataset
    yields it, so every sample counts once."""
    dev = next(gen.parameters()).device
    was_training = gen.training
    gen.eval()
    sums: Dict[str, float] = {}
    count = 0
    last = None
    try:
        for batch in dataset:
            tb = to_device(batch, dev)
            metrics, f = eval_batch(gen, tb, cfg)
            for k, v in metrics.items():
                sums[k] = sums.get(k, 0.0) + float(torch.sum(v))
            count += next(iter(metrics.values())).shape[0]
            last = (tb, f)
    finally:
        gen.train(was_training)
    if count == 0:
        return {}
    avg = {k: v / count for k, v in sums.items()}
    if out_dir is not None and last is not None:
        _save_grid(*last, out_dir, epoch)
    return avg


def _to_u8(x):
    x = np.asarray(x)
    lo, hi = x.min(), x.max()
    return ((x - lo) / (hi - lo + 1e-8) * 255).astype(np.uint8)


def _save_grid(tb, f, out_dir, epoch):
    os.makedirs(out_dir, exist_ok=True)
    panels = [
        tb["context"], f["fake_b"], tb["full"], f["coarse_seg_bin"],
        tb["normal_vert"], f["fine_seg_bin"], tb["vert_seg"], tb["cam"],
    ]
    panels = [p.float().cpu().numpy() for p in panels]
    rows = []
    for i in range(min(4, panels[0].shape[0])):
        rows.append(np.concatenate([_to_u8(p[i, :, :, 0]) for p in panels], axis=1))
    write_png(os.path.join(out_dir, f"nepoch_{epoch:03d}_eval.png"), np.concatenate(rows, axis=0))
