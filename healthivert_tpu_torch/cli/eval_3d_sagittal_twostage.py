"""Iterative two-stage 3D synthesis CLI of the port.

Counterpart of the root eval_3d_sagittal_twostage.py, with its flags:

    python -m healthivert_tpu_torch.cli.eval_3d_sagittal_twostage \\
        --dataroot <dir-with-CT,label> --name exp --epoch latest \\
        --results_dir ./output_3d [--cam_dir ...] [--load_npz weights.npz]

For each {patient}_{vert}.nii.gz under {dataroot}/CT, synthesizes the
pseudo-healthy vertebra (upper neighbour -> lower neighbour -> target, all
slices batched per pass, a patient's vertebrae sharing the passes) and
writes CT_fake/ and label_fake/ NIfTIs with the input's affine. Outputs
that exist are skipped. Runs on the card of --gpu_ids (default 0);
--gpu_ids -1 runs on the CPU. Several ids (--gpu_ids 0,1,2,3) shard each
pass's slice batches over those cards in this one process, on the mesh of
--mesh (default data:-1, every listed card).

--compute_dtype int8 --int8_calib auto (the default calibration) calibrates
static int8 scales on the first batch and keeps them in
{checkpoints_dir}/{name}/int8_quant.pt, which later runs reuse;
--int8_calib dynamic takes per-sample scales.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ..config.options import TestOptions, gpu_id_list
from ..data.aligned import find_cam_path
from ..engine import checkpoint as ckpt
from ..engine.infer3d import synthesize_volumes
from ..models.pix2pix import Pix2PixConfig
from ..parallel.mesh import make_mesh
from ..utils import nifti
from ..utils.device import float32_exact
from .common import load_npz_parser, options_with

QUANT_STORE = "int8_quant.pt"  # the int8 scale store in {checkpoints_dir}/{name}


def pre_parser() -> argparse.ArgumentParser:
    pre = load_npz_parser()
    pre.add_argument("--axis", choices=["sagittal", "coronal"], default="sagittal")
    pre.add_argument("--slice_batch", type=int, default=64,
                     help="slices per device dispatch in each synthesis pass")
    pre.add_argument("--spine_batch", type=int, default=1,
                     help="1 (default): batch all of a patient's vertebrae through "
                          "shared synthesis passes; 0: one vertebra per pass set "
                          "(reference-style serial order)")
    # this inference CLI defaults to bfloat16, as the root CLI
    pre.add_argument("--compute_dtype", default="bfloat16",
                     choices=["float32", "bfloat16", "int8"])
    return pre


def main(argv=None):
    float32_exact()
    pre = pre_parser()
    ns, rest = pre.parse_known_args(argv)
    axis = 2 if ns.axis == "sagittal" else 1
    rest = list(rest) + ["--compute_dtype", ns.compute_dtype]
    opt = options_with(pre, TestOptions).parse(rest)
    dev = opt.device
    mesh = card_mesh(opt)
    cfg = Pix2PixConfig(ngf=16, image_size=opt.crop_size, compute_dtype=opt.compute_dtype)
    gen = ckpt.generator_for_cli(opt, cfg, dev, load_npz=ns.load_npz)
    # int8: static scales by default, persisted beside the checkpoint so that
    # every later run (any --slice_batch or grouping) reuses them
    static = cfg.compute_dtype == "int8" and opt.int8_calib == "auto"
    quant = dict(quant="auto" if static else None,
                 quant_store=os.path.join(opt.checkpoints_dir, opt.name, QUANT_STORE)
                 if static else None)

    ct_dir = os.path.join(opt.dataroot, "CT")
    out_ct = os.path.join(opt.results_dir, "CT_fake")
    out_lb = os.path.join(opt.results_dir, "label_fake")
    os.makedirs(out_ct, exist_ok=True)
    os.makedirs(out_lb, exist_ok=True)

    files = sorted(f for f in os.listdir(ct_dir) if f.endswith(".nii.gz"))
    # crude resumability, as the reference: outputs that exist are skipped
    files = [f for f in files if not os.path.exists(os.path.join(out_ct, f))]

    # group a patient's vertebrae so their three synthesis passes share
    # device dispatches (--spine_batch 0 restores one-vertebra groups)
    groups: dict = {}
    for f in files:
        patient = f[: -len(".nii.gz")].rsplit("_", 1)[0] if ns.spine_batch else f
        groups.setdefault(patient, []).append(f)

    # NIfTI reads and gzip writes run on a thread pool (zlib releases the
    # GIL); a patient's outputs are written while the next one synthesizes
    io = ThreadPoolExecutor(max_workers=max(1, min(8, os.cpu_count() or 1)))
    stats = dict(patients=[], io_read_s=0.0, io_write_s=0.0)
    writes = []
    done = 0
    t_all = time.perf_counter()
    try:
        for patient, group in groups.items():
            t0 = time.perf_counter()
            vols, imgs = load_group(io, opt, group)
            t_read = time.perf_counter() - t0
            results = synthesize_group(gen, cfg, vols, axis, ns.slice_batch, dev, mesh=mesh,
                                       **quant)
            for w in writes:  # the previous patient's files, before the next ones
                stats["io_write_s"] += w.result()
            writes = [io.submit(_save, r, img, out_ct, out_lb, fname)
                      for fname, img, r in zip(group, imgs, results)]
            done += len(group)
            stats["io_read_s"] += t_read
            stats["patients"].append(time.perf_counter() - t0)
            print(f"[{done}/{len(files)}] {patient}: {len(group)} vertebra(e) "
                  f"synthesized in {time.perf_counter() - t0:.1f}s")
        for w in writes:
            stats["io_write_s"] += w.result()
    finally:
        io.shutdown(wait=True)
    stats["total_s"] = time.perf_counter() - t_all
    return stats


def card_mesh(opt):
    """The mesh of --mesh over the cards of --gpu_ids when it lists more
    than one, else None (one device, unsharded dispatches)."""
    ids = gpu_id_list(opt.gpu_ids)
    if len(ids) < 2:
        return None
    mesh = make_mesh(opt.mesh, devices=[f"cuda:{i}" for i in ids])
    print(f"sharding slice batches over mesh {dict(mesh.shape)}")
    return mesh


def load_group(io, opt, group):
    """(volumes for synthesize_volumes, CT images) of a group's files."""

    def one(fname):
        ct_img = nifti.load(os.path.join(opt.dataroot, "CT", fname))
        lb_img = nifti.load(os.path.join(opt.dataroot, "label", fname))
        pv = fname[: -len(".nii.gz")]
        cam = None
        if opt.cam_dir:
            cp = find_cam_path(opt.cam_dir, pv)
            if cp:
                cam = nifti.load(cp).get_fdata().astype(np.float32)
        vol = (ct_img.get_fdata(), lb_img.get_fdata(), int(pv.rsplit("_", 1)[1]), cam)
        return vol, ct_img

    loaded = list(io.map(one, group))
    return [v for v, _ in loaded], [img for _, img in loaded]


def synthesize_group(gen, cfg, vols, axis, slice_batch, dev, mesh=None, quant=None,
                     quant_store=None):
    """synthesize_volumes over one group. It stacks slices across volumes,
    so all must share the slice shape along `axis`; a group with mismatched
    shapes runs as per-shape sub-groups."""

    def slice_shape(v):
        s = v[0].shape
        return (s[0], s[1]) if axis == 2 else (s[0], s[2])

    by_shape: dict = {}
    for i, v in enumerate(vols):
        by_shape.setdefault(slice_shape(v), []).append(i)
    results = [None] * len(vols)
    for idxs in by_shape.values():
        sub = synthesize_volumes(gen, cfg, [vols[i] for i in idxs], batch_size=slice_batch,
                                 use_bf16=cfg.compute_dtype != "float32", axis=axis,
                                 mesh=mesh, quant=quant, quant_store=quant_store, device=dev)
        for i, r in zip(idxs, sub):
            results[i] = r
    return results


def _save(result, ct_img, out_ct, out_lb, fname) -> float:
    t0 = time.perf_counter()
    ct_fake, lb_fake = result
    nifti.save(nifti.Nifti1Image(ct_fake.astype(np.float32), ct_img.affine),
               os.path.join(out_ct, fname))
    nifti.save(nifti.Nifti1Image(lb_fake.astype(np.float32), ct_img.affine),
               os.path.join(out_lb, fname))
    return time.perf_counter() - t0


if __name__ == "__main__":
    main(sys.argv[1:])
