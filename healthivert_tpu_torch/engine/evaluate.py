"""In-training evaluation: masked SSIM/PSNR, coarse Dice, fine IoU, height
error, and the eval PNG grid.

Counterpart of healthivert_tpu/engine/evaluate.py:23-129 (parity with the
reference train.py:50-160): one batched generator forward per eval batch,
per-sample metrics on the device, and only the sums leave it. With a mesh
(one process, parallel/mesh.make_mesh) each batch is split over the mesh's
data shards, each on the first device of its model group
(`Mesh.data_devices`), one generator replica a device.
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
from ..parallel.mesh import pad_batch, replicate_state, shard_batch
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


GRID_PANELS = (("batch", "context"), ("out", "fake_b"), ("batch", "full"),
               ("out", "coarse_seg_bin"), ("batch", "normal_vert"), ("out", "fine_seg_bin"),
               ("batch", "vert_seg"), ("batch", "cam"))


def evaluate_model(gen: Generator, dataset, cfg: Pix2PixConfig, out_dir=None, epoch=0,
                   mesh=None):
    """Average metrics over the eval dataset; optionally save a PNG grid of
    [context, fake, real, coarse_seg, normal, fine_seg, vert_seg, cam] rows
    (train.py:150-159). Each batch is evaluated at the size the dataset
    yields it, so every sample counts once.

    mesh: a one-process mesh; each batch is padded by repetition to a
    multiple of its data size, split over its data shards, and the padded
    entries are dropped from the sums."""
    if mesh is not None and mesh.processes > 1:
        raise ValueError("evaluate_model(mesh=...) is single-process only; "
                         "multi-process runs evaluate host-locally per process")
    dev = next(gen.parameters()).device
    replicas = replicate_state(gen, mesh) if mesh is not None else [gen]
    was_training = [g.training for g in replicas]
    for g in replicas:
        g.eval()
    sums: Dict[str, float] = {}
    count = 0
    last = None
    try:
        for batch in dataset:
            n = next(iter(batch.values())).shape[0]
            parts = [to_device(batch, dev)] if mesh is None else shard_batch(
                pad_batch(batch, -(-n // mesh.size) * mesh.size), mesh)
            results = [eval_batch(g, tb, cfg) for g, tb in zip(replicas, parts)]
            metrics = results[0][0] if mesh is None else {
                k: torch.cat([m[k].cpu() for m, _ in results])[:n] for k in results[0][0]}
            for k, v in metrics.items():
                sums[k] = sums.get(k, 0.0) + float(torch.sum(v))
            count += n
            last = [(tb, f) for tb, (_, f) in zip(parts, results)]
    finally:
        for g, flag in zip(replicas, was_training):
            g.train(flag)
    if count == 0:
        return {}
    avg = {k: v / count for k, v in sums.items()}
    if out_dir is not None and last is not None:
        panels = [torch.cat([(tb if src == "batch" else f)[key].float().cpu()
                             for tb, f in last]) for src, key in GRID_PANELS]
        _save_grid(panels, out_dir, epoch)
    return avg


def _to_u8(x):
    x = np.asarray(x)
    lo, hi = x.min(), x.max()
    return ((x - lo) / (hi - lo + 1e-8) * 255).astype(np.uint8)


def _save_grid(panels, out_dir, epoch):
    """The eval PNG: up to four rows of the panels (GRID_PANELS, tensors of
    the last batch)."""
    os.makedirs(out_dir, exist_ok=True)
    panels = [p.numpy() for p in panels]
    rows = []
    for i in range(min(4, panels[0].shape[0])):
        rows.append(np.concatenate([_to_u8(p[i, :, :, 0]) for p in panels], axis=1))
    write_png(os.path.join(out_dir, f"nepoch_{epoch:03d}_eval.png"), np.concatenate(rows, axis=0))
