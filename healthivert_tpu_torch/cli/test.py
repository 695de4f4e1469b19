"""Test CLI of the port: run the generator over the test split and write an
HTML gallery; the counterpart of the root test.py (batch 1, serial, no
flip, results under {results_dir}/{name}/{phase}_{epoch}[_iter{N}]/
index.html, with the attention's offset flow as an 8x upsampled image).

    python -m healthivert_tpu_torch.cli.test --dataroot ... --name exp \\
        [--load_npz weights.npz]

Runs on the card of --gpu_ids (default 0); --gpu_ids -1 runs on the CPU.
--compute_dtype int8 calibrates static int8 scales on the first image
(--int8_calib auto, the default) or takes per-sample ones (dynamic).
"""

from __future__ import annotations

import os
import sys

import torch

from ..config.options import TestOptions
from ..data import create_dataset
from ..data.prefetch import to_device
from ..engine import checkpoint as ckpt
from ..engine.visualizer import HTMLGallery, save_images
from ..models.pix2pix import (
    INT8_CALIB_PERCENTILE,
    Pix2PixConfig,
    calibrate_int8,
    generator_forward,
)
from ..ops.flow_viz import offsets_to_flow_image
from ..utils.device import float32_exact
from .common import load_npz_parser, options_with


def main(argv=None):
    float32_exact()
    pre = load_npz_parser()
    ns, rest = pre.parse_known_args(argv)
    opt = options_with(pre, TestOptions).parse(rest)
    # hard-coded test settings (reference test.py:45-48)
    opt.batch_size = 1
    opt.serial_batches = True
    opt.no_flip = True

    # compute_offsets: the reference renders the attention offset flow as a
    # standard visual every forward (inpaint_networks.py:368-374,389-408)
    cfg = Pix2PixConfig(ngf=16, ndf=opt.ndf, image_size=opt.crop_size, compute_offsets=True,
                        compute_dtype=opt.compute_dtype)
    dataset = create_dataset(opt)
    gen = ckpt.generator_for_cli(opt, cfg, opt.device, load_npz=ns.load_npz)

    web_dir = os.path.join(opt.results_dir, opt.name, f"{opt.phase}_{opt.epoch}")
    if getattr(opt, "load_iter", 0) > 0:
        # keep galleries from different --load_iter runs distinct
        # (reference test.py:61-62)
        web_dir = f"{web_dir}_iter{opt.load_iter}"
    gallery = HTMLGallery(web_dir, f"Experiment = {opt.name}, Phase = {opt.phase}, "
                                   f"Epoch = {opt.epoch}")
    host = lambda t: t[0].float().cpu().numpy()
    g_quant = None
    for i, batch in enumerate(dataset):
        if i >= opt.num_test:
            break
        tb = to_device(batch, opt.device)
        if cfg.compute_dtype == "int8" and i == 0 and opt.int8_calib == "auto":
            # static per-tensor activation scales from the first batch
            g_quant = calibrate_int8(gen, [tb], cfg, percentile=INT8_CALIB_PERCENTILE)
        with torch.no_grad():
            f = generator_forward(gen, tb, cfg, g_quant=g_quant)
        visuals = {
            "real_A": host(tb["context"]),
            "fake_B": host(f["fake_b"]),
            "real_B": host(tb["full"]),
            "fake_B_mask": host(f["fine_seg_bin"]),
            "real_B_mask": host(tb["vert_seg"]),
            "coarse_seg": host(f["coarse_seg_bin"]),
        }
        # rate * 4 = 8x nearest upsample back to image size (reference
        # inpaint_networks.py:405-407); host-side, on demand only
        visuals["offset_flow"] = offsets_to_flow_image(
            f["gen"].offsets.cpu().numpy(), upscale=8)[0]
        save_images(gallery, visuals, f"{i:04d}", width=opt.display_winsize,
                    aspect_ratio=getattr(opt, "aspect_ratio", 1.0))
        if i % 5 == 0:
            print(f"processing ({i:04d})-th image...")
    gallery.save()
    print(f"wrote {web_dir}/index.html")
    return cfg


if __name__ == "__main__":
    main(sys.argv[1:])
