"""The training driver: epoch loop, learning-rate schedule, printed losses.

Counterpart of healthivert_tpu/engine/train_loop.py:92-310 on one device.
Not ported yet (queued in ROADMAP.md): the device mesh and multi-process
runs, periodic evaluation, web visuals, the profiler window, checkpoint
save and resume, and device prefetch of batches.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from ..data import create_dataset
from ..models.pix2pix import LRSchedule, Pix2PixConfig, init_state, train_step
from ..utils.device import resolve_device


def config_from_opt(opt) -> Pix2PixConfig:
    """The training config of a train.py option namespace."""
    return Pix2PixConfig(
        ngf=16,  # the reference hard-codes the generator width
        ndf=opt.ndf,
        net_d=getattr(opt, "netD", "basic"),
        n_layers_d=getattr(opt, "n_layers_D", 3),
        norm=getattr(opt, "norm", "batch"),
        lr=opt.lr,
        beta1=opt.beta1,
        lambda_l1=getattr(opt, "lambda_L1", 200.0),
        gan_mode=opt.gan_mode,
        init_type=getattr(opt, "init_type", "normal"),
        init_gain=getattr(opt, "init_gain", 0.02),
        image_size=opt.crop_size,
        compute_dtype=getattr(opt, "compute_dtype", "float32"),
        remat=getattr(opt, "remat", False),
        gan_head_preupdate=getattr(opt, "gan_head_preupdate", True),
        crop_d3=getattr(opt, "crop_d3", True),
    )


def _print_networks(state):
    """Parameter-count banner, in the reference's print_networks format."""
    print("---------- Networks initialized -------------")
    for name, net in (("G", state.gen), ("D_1", state.d1), ("D_2", state.d2),
                      ("D_3", state.d3)):
        n = sum(p.numel() for p in net.parameters())
        print("[Network %s] Total number of parameters : %.3f M" % (name, n / 1e6))
    print("-----------------------------------------------")


def _check_finite(losses, step):
    host = {k: float(v) for k, v in losses.items()}
    bad = [k for k, v in host.items() if not math.isfinite(v)]
    if bad:
        # stop rather than burn epochs on a diverged run
        raise FloatingPointError(f"non-finite losses at step {step}: {bad}")
    return host


def run_training(opt, max_steps=None, device="cuda", on_step=None):
    """Train on one device from the options of train.py; returns (state, cfg).

    The generator starts from opt.load_npz (an exported ``.npz``) when set,
    else from the port's own initialisation; the discriminators from theirs;
    all seeded by opt.seed. Losses are printed, and checked to be finite,
    every opt.print_freq samples and after the last step: a non-finite loss
    raises FloatingPointError. max_steps ends the run after that many steps.
    on_step(step, losses), when given, is called after every step with the
    losses as device tensors."""
    if getattr(opt, "compute_dtype", "float32") == "int8":
        raise SystemExit("--compute_dtype int8 is inference-only; train in "
                         "bfloat16/float32")
    cfg = config_from_opt(opt)
    dev = resolve_device(device)
    dataset = create_dataset(opt)
    print(f"The number of training images = {len(dataset)}")
    state = init_state(cfg, seed=opt.seed, device=dev,
                       gen_npz=getattr(opt, "load_npz", None))
    _print_networks(state)
    schedule = LRSchedule(opt)
    total_iters = 0
    losses = None
    done = False
    for epoch in range(opt.epoch_count, opt.n_epochs + opt.n_epochs_decay + 1):
        epoch_start = time.time()
        lr = opt.lr * schedule.scale(epoch)
        print(f"learning rate {lr:.7f} for epoch {epoch}")
        epoch_iter = 0
        iter_data_time = time.time()
        for batch in dataset:
            iter_start = time.time()
            t_data = iter_start - iter_data_time
            batch = {k: torch.from_numpy(np.asarray(v)).to(dev)
                     for k, v in batch.items()}
            total_iters += opt.batch_size
            epoch_iter += opt.batch_size
            state, losses = train_step(state, batch, lr, cfg)
            if on_step is not None:
                on_step(state.step, losses)
            if total_iters % opt.print_freq < opt.batch_size:
                host = _check_finite(losses, state.step)
                t_comp = (time.time() - iter_start) / opt.batch_size
                msg = " ".join(f"{k}: {v:.3f}" for k, v in host.items())
                print(f"(epoch: {epoch}, iters: {epoch_iter}, time: {t_comp:.3f}, "
                      f"data: {t_data:.3f}) {msg}")
            iter_data_time = time.time()
            if max_steps is not None and state.step >= max_steps:
                done = True
                break
        print(f"End of epoch {epoch} / {opt.n_epochs + opt.n_epochs_decay} \t "
              f"Time Taken: {int(time.time() - epoch_start)} sec")
        if done:
            break
    if losses is not None:
        host = _check_finite(losses, state.step)
        print("final losses: " + " ".join(f"{k}: {v:.3f}" for k, v in host.items()))
    return state, cfg
