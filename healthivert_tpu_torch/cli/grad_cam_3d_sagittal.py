"""HGAM heatmap CLI of the port: train the fracture classifier on a
straightened dataset, and write per-vertebra Grad-CAM++ heatmap NIfTIs.

Counterpart of the root Attention/grad_CAM_3d_sagittal.py, with its flags
and defaults:

    # train the classifier on a straightened dataset + split json:
    python -m healthivert_tpu_torch.cli.grad_cam_3d_sagittal train --dataroot <dir> \\
        --split vertebra_data.json --out <ckpt-dir> [--steps 500]
    # generate heatmaps:
    python -m healthivert_tpu_torch.cli.grad_cam_3d_sagittal generate --dataroot <dir> \\
        --split vertebra_data.json --ckpt <ckpt-dir> --out <heatmap-dir>

`train` writes {out}/classifier.pt and {out}/meta.json (z_context, band);
`generate` reads them and writes {pv}_{cls}.nii.gz, cls the classifier's
per-vertebra majority vote (0 normal, 1 fractured), the heatmap in [0, 1]
pasted at the vertebra's band rows and slices of a zero volume: the CAMs
that the datasets' and the 3D CLI's --cam_dir read. Without a checkpoint,
`generate` warns and uses init weights, as the root script does; a --ckpt
holding only the JAX package's orbax classifier/ raises.

Runs on the card of --gpu_ids (default 0, which raises without a card);
--gpu_ids -1 runs on the CPU. The root script pads each vertebra's slices
to a multiple of 8 so that XLA reuses its compilations (`pad8`); a
vertebra's votes and CAMs do not depend on it (GroupNorm is per sample),
so the port sends the slices as they are.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from ..config.options import device_from_gpu_ids
from ..engine.checkpoint import (
    latest_exists,
    orbax_exists,
    restore_classifier,
    save_classifier,
)
from ..models.hgam import (
    FractureClassifier,
    classifier_train_step,
    grad_cam_pp,
    init_classifier,
    make_optimizer,
)
from ..utils import nifti
from ..utils.device import float32_exact


def _slice_plan(labels, vert_id, band=0):
    """Which slices `_slices_for` stacks for a vertebra: (central-4/5 z
    indices, band row offset, band rows); (None, 0, band) when the vertebra
    is absent."""
    vert = labels == vert_id
    zs = np.nonzero(vert.any(axis=(0, 1)))[0]
    if zs.size == 0:
        return None, 0, band
    z0, z1 = int(zs.min()), int(zs.max())
    n = z1 - z0 + 1
    lo = z0 + (n - int(n * 4 / 5)) // 2
    hi = lo + int(n * 4 / 5)
    idx = list(range(lo, max(hi, lo + 1)))
    r0 = 0
    if band:
        band = min(band, labels.shape[0])
        rows = np.nonzero(vert.any(axis=(1, 2)))[0]
        center = int(rows.mean()) if rows.size else labels.shape[0] // 2
        r0 = min(max(center - band // 2, 0), labels.shape[0] - band)
    return idx, r0, band


def _stack(ct, z, r0, band, z_context):
    """One input of the classifier: slice z and its +-z_context neighbours
    (clamped at the volume's edges) as channels, rows [r0, r0 + band) (all
    rows when band is 0), normalized to [-1, 1]."""
    nz = ct.shape[2]
    zs = [min(max(z + d, 0), nz - 1) for d in range(-z_context, z_context + 1)]
    rows = ct[r0:r0 + band] if band else ct
    return rows[:, :, zs].astype(np.float32) / 255.0 * 2 - 1


def _slices_for(ct, labels, vert_id, z_context=0, band=0):
    """Central-4/5 sagittal slices of a vertebra, normalized to [-1, 1].

    z_context=k stacks each centre slice with its +-k sagittal neighbours as
    channels (clamped at the volume's edges). band=B crops each slice to a
    B-row window centred on the target vertebra's rows (clamped at the
    edges), so that the per-vertebra label applies to what the classifier
    sees.

    Returns (stacks (N, band or H, W, 2k+1), z indices, band row offset);
    (None, None, 0) when the vertebra is absent."""
    idx, r0, band = _slice_plan(labels, vert_id, band)
    if idx is None:
        return None, None, 0
    return np.stack([_stack(ct, z, r0, band, z_context) for z in idx]), idx, r0


class VolumeCache:
    """The last 64 (float32 CT, int16 labels, affine) volumes read: a
    cohort names one volume through many per-vertebra files, each read
    once."""

    def __init__(self, dataroot, size=64):
        self.dataroot, self.size, self.vols = dataroot, size, {}

    def __call__(self, pv):
        if pv not in self.vols:
            img = nifti.load(os.path.join(self.dataroot, "CT", pv + ".nii.gz"))
            lb = nifti.load(os.path.join(self.dataroot, "label", pv + ".nii.gz")).get_fdata()
            if len(self.vols) >= self.size:
                self.vols.pop(next(iter(self.vols)))
            self.vols[pv] = (img.get_fdata().astype(np.float32), lb.astype(np.int16), img.affine)
        return self.vols[pv]


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("mode", choices=["train", "generate"])
    p.add_argument("--dataroot", required=True)
    p.add_argument("--split", default="vertebra_data.json")
    p.add_argument("--phase", default="train")
    p.add_argument("--out", required=True)
    p.add_argument("--ckpt", default=None)
    p.add_argument("--steps", type=int, default=500)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--z_context", type=int, default=2,
                   help="2.5D input: each sample is the center slice +- this many sagittal "
                        "neighbors as channels (0 = a 2D classifier). 'generate' reads the "
                        "value the checkpoint was trained with from its meta.json when present")
    p.add_argument("--band", type=int, default=128,
                   help="crop each slice to this many rows centered on the target vertebra "
                        "(0 = full height); localizes the per-vertebra label. 'generate' "
                        "reads the trained value from meta.json when present")
    p.add_argument("--gpu_ids", type=str, default="0",
                   help="the card to run on; -1 selects the CPU")
    return p.parse_args(argv)


def new_classifier(chans, seed, device) -> FractureClassifier:
    """The classifier at its default width on `chans` input channels, with
    flax's initialisation drawn from a generator seeded with `seed`."""
    model = FractureClassifier(in_ch=chans)
    init_classifier(model, torch.Generator().manual_seed(seed))
    return model.to(device)


def _exists(args, pv):
    return os.path.exists(os.path.join(args.dataroot, "CT", pv + ".nii.gz"))


def _vert_slices(args, load_pv, pv):
    ct, lb, affine = load_pv(pv)
    sl, idx, r0 = _slices_for(ct, lb, int(pv.rsplit("_", 1)[1]),
                              z_context=args.z_context, band=args.band)
    return sl, idx, r0, ct, affine


@torch.no_grad()
def slice_preds(model, x: torch.Tensor) -> np.ndarray:
    """The class argmax of each slice."""
    return torch.argmax(model(x), -1).cpu().numpy()


def vert_vote(model, args, load_pv, pv, device):
    """Per-vertebra majority vote (what `generate` writes into the heatmap's
    suffix); None when the vertebra is absent."""
    sl, _, _, _, _ = _vert_slices(args, load_pv, pv)
    if sl is None:
        return None
    return int(slice_preds(model, torch.from_numpy(sl).to(device)).mean() > 0.5)


def train(args, model, device) -> dict:
    """Train `model` for args.steps class-balanced batches (the root script's
    draws from np.random.default_rng(args.seed)), print the loss every 50
    steps and the held-out vote accuracy on val and test, and save the
    classifier and meta.json to args.out. Returns each step's loss and its
    host (batch assembly) and device seconds, and the accuracies."""
    load_pv = VolumeCache(args.dataroot)
    with open(args.split) as f:
        split = json.load(f)
    rng = np.random.default_rng(args.seed)
    items = [(pv, 1 if int(g) > 1 else 0) for pv, g in split[args.phase].items()
             if _exists(args, pv)]
    if not items:
        raise SystemExit("no training volumes found")
    # class-balanced sampling: each example's class is drawn fairly
    pos = [it for it in items if it[1] == 1]
    neg = [it for it in items if it[1] == 0]
    plans = {}  # a vertebra's slice plan, computed once
    opt = make_optimizer(model)
    model.train()
    stats = dict(loss=[], host_s=[], device_s=[], vote_accuracy={})
    for step in range(args.steps):
        t0 = time.perf_counter()
        xs, ys = [], []
        while len(xs) < args.batch:
            pool = items
            if pos and neg:
                pool = pos if rng.random() < 0.5 else neg
            pv, y = pool[rng.integers(len(pool))]
            ct, lb, _ = load_pv(pv)
            if pv not in plans:
                plans[pv] = _slice_plan(lb, int(pv.rsplit("_", 1)[1]), args.band)
            idx, r0, band = plans[pv]
            if idx is None:
                continue
            # the root script stacks all of the vertebra's slices and takes
            # one; the port builds only the one drawn (the same values)
            xs.append(_stack(ct, idx[rng.integers(len(idx))], r0, band, args.z_context))
            ys.append(y)
        x = torch.from_numpy(np.stack(xs)).to(device)
        y = torch.from_numpy(np.array(ys)).to(device)
        t1 = time.perf_counter()
        loss, acc = classifier_train_step(model, opt, x, y, args.lr)
        loss, acc = float(loss), float(acc)
        t2 = time.perf_counter()
        stats["loss"].append(loss)
        stats["host_s"].append(t1 - t0)
        stats["device_s"].append(t2 - t1)
        if step % 50 == 0:
            print(f"step {step}: loss {loss:.4f} acc {acc:.3f}")
    model.eval()
    for phase in ("val", "test"):
        pvs = [(pv, 1 if int(g) > 1 else 0) for pv, g in split.get(phase, {}).items()
               if _exists(args, pv)]
        votes = [(vert_vote(model, args, load_pv, pv, device), y) for pv, y in pvs]
        votes = [(v, y) for v, y in votes if v is not None]
        if votes:
            acc = sum(int(v == y) for v, y in votes) / len(votes)
            stats["vote_accuracy"][phase] = (acc, len(votes))
            print(f"{phase} vertebra accuracy: {acc:.3f} ({len(votes)} verts)")
    save_classifier(model, args.out)
    with open(os.path.join(args.out, "meta.json"), "w") as f:
        json.dump({"z_context": args.z_context, "band": args.band}, f)
    print(f"saved classifier to {args.out}/classifier.pt "
          f"(z_context={args.z_context}, band={args.band})")
    return stats


def generate(args, model, device) -> dict:
    """Write {pv}_{cls}.nii.gz for every vertebra of the split found under
    args.dataroot. Returns each vertebra's class and seconds."""
    load_pv = VolumeCache(args.dataroot)
    with open(args.split) as f:
        split = json.load(f)
    os.makedirs(args.out, exist_ok=True)
    model.eval()
    pvs = [pv for phase in split.values() for pv in phase if _exists(args, pv)]
    stats = dict(classes={}, seconds={})
    for pv in sorted(set(pvs)):
        t0 = time.perf_counter()
        sl, idx, r0, ct, affine = _vert_slices(args, load_pv, pv)
        if sl is None:
            continue
        x = torch.from_numpy(sl).to(device)
        cls = int(slice_preds(model, x).mean() > 0.5)
        cams = grad_cam_pp(model, x, target_class=1).cpu().numpy()
        vol = np.zeros_like(ct, np.float32)
        for k, z in enumerate(idx):
            vol[r0:r0 + cams.shape[1], :, z] = cams[k, :, :, 0]
        nifti.save(nifti.Nifti1Image(vol, affine), os.path.join(args.out, f"{pv}_{cls}.nii.gz"))
        stats["classes"][pv] = cls
        stats["seconds"][pv] = time.perf_counter() - t0
        print(f"{pv}: class {cls}, {len(idx)} slices")
    return stats


def main(argv=None):
    float32_exact()
    args = parse_args(argv)
    device = device_from_gpu_ids(args.gpu_ids)
    if args.mode == "train":
        model = new_classifier(2 * args.z_context + 1, args.seed, device)
        return train(args, model, device)
    # the input channels and the band must match the trained checkpoint
    meta_path = os.path.join(args.ckpt or "", "meta.json")
    if args.ckpt and os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
        args.z_context = int(meta.get("z_context", args.z_context))
        args.band = int(meta.get("band", args.band))
    model = new_classifier(2 * args.z_context + 1, args.seed, device)
    if args.ckpt and (latest_exists(args.ckpt, "classifier")
                      or orbax_exists(args.ckpt, "classifier")):
        restore_classifier(model, args.ckpt)
        print(f"loaded classifier from {args.ckpt}/classifier.pt")
    else:
        print("warning: no classifier checkpoint; heatmaps from init weights")
    return generate(args, model, device)


if __name__ == "__main__":
    main(sys.argv[1:])
