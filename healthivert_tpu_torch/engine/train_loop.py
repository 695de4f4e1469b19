"""The training loop: epoch loop, LR schedule, checkpoints, periodic eval.

Counterpart of healthivert_tpu/engine/train_loop.py:39-310 (structure
parity with the reference train.py:162-236: print/save cadences, eval every
`eval_freq` epochs, 'latest' + epoch checkpoints). Batches are built ahead
on a background thread and copied to the device (depth 2); a trailing
partial batch is padded back to the batch size by cyclic repetition, as the
JAX loop does.

Data parallelism runs one process per card under torchrun
(parallel/distributed.py): each rank trains on its slice of the global
batch --batch_size, the step averages the gradients over the ranks, rank 0
alone writes the logs, web visuals and checkpoints, and every rank evaluates
the whole eval split.
"""

from __future__ import annotations

import json
import math
import os
import time

import numpy as np
import torch

from ..data import create_dataset
from ..data.prefetch import prefetch_to_device, to_device
from ..models.pix2pix import LRSchedule, Pix2PixConfig, generator_forward, init_state, train_step
from ..parallel import distributed
from ..parallel.mesh import make_mesh, pad_batch, replicate_state
from ..utils import spans
from ..utils.device import resolve_device
from . import checkpoint as ckpt
from .evaluate import evaluate_model
from .visualizer import HTMLGallery, Visualizer, save_images


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


def _save_web_visuals(state, batch, cfg, run_dir, epoch, iters, visualizer=None):
    """Training-time HTML gallery (reference visdom/HTML panels,
    train.py:200-203): context / fake / real / seg rows under {run}/web."""
    with torch.no_grad():
        f = generator_forward(state.gen, batch, cfg)
    host = lambda t: t[0].float().cpu().numpy()
    gallery = HTMLGallery(os.path.join(run_dir, "web"), "training progress", history=True)
    visuals = {
        "real_A": host(batch["context"]),
        "fake_B": host(f["fake_b"]),
        "real_B": host(batch["full"]),
        "fake_B_mask": host(f["fine_seg_bin"]),
        "coarse_seg": host(f["coarse_seg_bin"]),
        "CAM": host(batch["cam"]),
    }
    save_images(gallery, visuals, f"epoch{epoch:03d}_{iters:07d}",
                header=f"epoch [{epoch}] iter {iters}")
    gallery.save()
    if visualizer is not None:
        visualizer.log_images(visuals, iters)


def _print_networks(state, verbose=False):
    """Parameter-count banner, in the reference's print_networks format."""
    print("---------- Networks initialized -------------")
    for name, net in (("G", state.gen), ("D_1", state.d1), ("D_2", state.d2),
                      ("D_3", state.d3)):
        if verbose:
            print(net)
        n = sum(p.numel() for p in net.parameters())
        print("[Network %s] Total number of parameters : %.3f M" % (name, n / 1e6))
    print("-----------------------------------------------")


class _Profiler:
    """The --profile_steps window: a torch.profiler trace of the steps in
    [START, STOP), written to {run_dir}/profile as a Chrome trace, with the
    count of its kernel launches and of those without a kernel record
    (`trace_kernel_records`): the profiler can lose the records of a
    session's first kernels. The program's span recorder (utils/spans.py)
    is on for the same steps; its records go beside the trace as
    spans.json, on the clock of the trace's host records."""

    def __init__(self, run_dir):
        self.out_dir = os.path.join(run_dir, "profile")
        self.prof = None

    def start(self):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.start()
        spans.enable()

    def stop(self, why=""):
        self.prof.stop()
        spans.disable()
        os.makedirs(self.out_dir, exist_ok=True)
        path = os.path.join(self.out_dir, "trace.json")
        self.prof.export_chrome_trace(path)
        self.prof = None
        with open(os.path.join(self.out_dir, "spans.json"), "w") as f:
            json.dump([r._asdict() for r in spans.drain()], f)
        launches, lost = trace_kernel_records(path)
        print(f"profiler trace{why} written to {self.out_dir}: {launches} kernel launches, "
              f"{lost} without a kernel record")

    @property
    def on(self):
        return self.prof is not None


def trace_kernel_records(path):
    """(kernel launches, those without a kernel record) in a Chrome trace of
    torch.profiler: the launch calls (cudaLaunchKernel, cuLaunchKernel and
    their variants) matched to kernel records by correlation id."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = {e["args"].get("correlation") for e in events
               if e.get("cat") == "kernel" and "args" in e}
    launches = [e["args"].get("correlation") for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver") and "args" in e
                and "Launch" in e.get("name", "")]
    return len(launches), sum(c not in kernels for c in launches)


def run_training(opt, opt_test=None, max_steps=None, profile_steps=None, device="cuda",
                 on_step=None):
    """Train on one device from the options of train.py; returns (state, cfg).

    The networks start from the seeded initialisation, the generator from
    opt.load_npz (an exported ``.npz``) when set; then --load_pth overlays
    the reference's G (and sibling D) files, and --continue_train restores
    {run_dir}/{tag}.pt. Every opt.print_freq samples the losses are logged
    (loss_log.txt, metrics.jsonl) and checked: a non-finite loss raises
    FloatingPointError. Checkpoints every save_latest_freq samples, at every
    save_epoch_freq-th epoch and at the last step; evaluation on opt_test's
    split every eval_freq epochs. profile_steps=(START, STOP) traces those
    steps. on_step(step, losses), when given, is called after every step
    with the losses as device tensors.

    Under torchrun (or a process group the caller started) each of the
    world's processes trains on `device` with the slice of the global batch
    opt.batch_size of its data coordinate on --mesh (a model axis's ranks
    take the same slice); a dataset that yields the global batch on every process
    (synthetic) is padded to the global size and sliced here, as in the JAX
    loop. The replicas start from rank 0's state."""
    if getattr(opt, "compute_dtype", "float32") == "int8":
        raise SystemExit("--compute_dtype int8 is inference-only; train in "
                         "bfloat16/float32")
    cfg = config_from_opt(opt)
    dev = resolve_device(device)
    world = distributed.ensure_initialized(device=dev)
    # one device a process: the mesh is the world (a --mesh asking for
    # another size raises, naming the torchrun command); the ranks of one
    # data coordinate train on the same slice, as model-axis replicas
    mesh = make_mesh(getattr(opt, "mesh", "data:-1"), devices=[dev])
    is_main = distributed.process_index() == 0
    shards = distributed.data_axis()[1]
    if opt.batch_size % shards != 0:
        raise ValueError(f"batch_size {opt.batch_size} must divide by the {shards} data shards")
    local_bs = opt.batch_size // shards
    local = distributed.process_batch_slice(opt.batch_size)
    dataset = create_dataset(opt)
    print(f"The number of training images = {len(dataset)}")
    eval_dataset = None
    if opt_test is not None:
        try:
            eval_dataset = create_dataset(opt_test)
        except FileNotFoundError as e:
            print(f"eval split unavailable ({e}); training without periodic eval")

    run_dir = os.path.join(opt.checkpoints_dir, opt.name)
    os.makedirs(run_dir, exist_ok=True)
    # logs, web visuals and checkpoints are written by rank 0 alone
    visualizer = Visualizer(opt) if is_main else None
    state = init_state(cfg, seed=opt.seed, device=dev,
                       gen_npz=getattr(opt, "load_npz", None))
    if is_main:
        _print_networks(state, verbose=getattr(opt, "verbose", False))
    if getattr(opt, "load_pth", None):
        # G + sibling D_1..3 files when present (load_networks parity)
        ckpt.restore_full_pth(state, opt.load_pth, n_layers_d=getattr(opt, "n_layers_D", 3))
    if getattr(opt, "continue_train", False):
        resume_tag = ckpt.resolve_tag(opt)  # --load_iter N > 0 picks iter_N
        if ckpt.latest_exists(run_dir, resume_tag):
            ckpt.restore_checkpoint(state, run_dir, resume_tag)
            print(f"resumed from {ckpt.checkpoint_path(run_dir, resume_tag)} at step {state.step}")
        elif ckpt.orbax_exists(run_dir, resume_tag):
            raise ckpt.orbax_error(run_dir, resume_tag)

    nets = (state.gen, state.d1, state.d2, state.d3)
    for net in nets:  # every rank starts from rank 0's replica
        replicate_state(net, mesh)

    profiler = _Profiler(run_dir)
    if not is_main:
        profile_steps = None  # rank 0 alone writes the trace
    if profile_steps and state.step >= profile_steps[1]:
        print(f"warning: --profile_steps window {profile_steps} is entirely before "
              f"the resume step {state.step}; no trace will be written")
        profile_steps = None
    schedule = LRSchedule(opt)
    last_metric = None
    total_iters = 0
    losses = None
    done = False

    def place(b):
        n = next(iter(b.values())).shape[0]
        if world > 1 and n > local_bs:
            # the dataset yielded the global batch on every process (the
            # synthetic one): keep this process's disjoint slice
            b = pad_batch(b, opt.batch_size)
            b = {k: v[local] for k, v in b.items()}
        else:
            b = pad_batch(b, local_bs)
        return to_device(b, dev)

    for epoch in range(opt.epoch_count, opt.n_epochs + opt.n_epochs_decay + 1):
        epoch_start = time.time()
        lr = opt.lr * schedule.scale(epoch, last_metric)
        print(f"learning rate {lr:.7f} for epoch {epoch}")
        epoch_iter = 0
        # time.time_ns: the clock of the spans (and of the profiler's host records)
        iter_data_time = time.time_ns()
        for batch in prefetch_to_device(dataset, place, depth=2):
            iter_start = time.time_ns()
            t_data = (iter_start - iter_data_time) / 1e9
            total_iters += opt.batch_size
            epoch_iter += opt.batch_size
            # >= so that a --continue_train resume landing inside [START,
            # STOP) still gives a (shortened) trace
            if profile_steps and not profiler.on and state.step >= profile_steps[0]:
                profiler.start()
            # the wait for the batch, the prefetch thread's restart at an
            # epoch's start included
            spans.record("hv.train.data", iter_data_time, iter_start, rid=state.step + 1)
            with spans.span("hv.train.step", rid=state.step + 1):
                state, losses = train_step(state, batch, lr, cfg)
            if on_step is not None:
                on_step(state.step, losses)
            if profiler.on and state.step >= profile_steps[1]:
                profiler.stop()
                profile_steps = None  # one-shot window

            if total_iters % opt.print_freq < opt.batch_size:
                with spans.span("hv.train.log", rid=state.step):
                    try:
                        host = _check_finite(losses, state.step)
                    except FloatingPointError:
                        if profiler.on:  # the diverging steps' trace is the one wanted
                            profiler.stop(" (divergence abort)")
                        raise
                    distributed.check_replicated(nets, f"networks at step {state.step}")
                    t_comp = (time.time_ns() - iter_start) / 1e9 / opt.batch_size
                    if is_main:
                        visualizer.print_current_losses(epoch, epoch_iter, host, t_comp, t_data)
                        visualizer.log_scalars("train", host, total_iters)

            if is_main and getattr(opt, "display_freq", 0) and \
                    total_iters % opt.display_freq < opt.batch_size:
                _save_web_visuals(state, batch, cfg, run_dir, epoch, total_iters, visualizer)

            if total_iters % opt.save_latest_freq < opt.batch_size:
                tag = f"iter_{total_iters}" if opt.save_by_iter else "latest"
                with spans.span("hv.train.save", rid=state.step):
                    ckpt.save_checkpoint(state, run_dir, tag)
            iter_data_time = time.time_ns()
            if max_steps is not None and state.step >= max_steps:
                done = True
                break

        if epoch % opt.save_epoch_freq == 0 or done:
            with spans.span("hv.train.save", rid=state.step):
                ckpt.save_checkpoint(state, run_dir, "latest")
                ckpt.save_checkpoint(state, run_dir, epoch)

        if eval_dataset is not None and epoch % getattr(opt, "eval_freq", 15) == 0:
            # every rank evaluates the whole split on its replica; rank 0's
            # averages go to all, so the plateau policy's metric, and the
            # learning rate, stay the same on every rank
            with spans.span("hv.train.eval", rid=state.step):
                avg = evaluate_model(state.gen, eval_dataset, cfg, epoch=epoch,
                                     out_dir=os.path.join(run_dir, "eval_imgs")
                                     if is_main else None)
                avg = _from_rank0(avg, dev)
            if avg:
                last_metric = -avg["ssim"]  # plateau policy input (minimized)
                if is_main:
                    visualizer.log_scalars("eval", avg, epoch)
                print(
                    f"epoch[{epoch}] SSIM: {avg['ssim']:.4f} PSNR: {avg['psnr']:.2f} "
                    f"Dice: {avg['dice']:.4f} IoU: {avg['iou']:.4f} DiffH: {avg['diff_h']:.2f}"
                )
        print(f"End of epoch {epoch} / {opt.n_epochs + opt.n_epochs_decay} \t "
              f"Time Taken: {int(time.time() - epoch_start)} sec")
        if done:
            break
    if profiler.on:
        # STOP landed past the last step: flush the trace instead of losing it
        profiler.stop(" (truncated at run end)")
    if losses is not None:
        host = _check_finite(losses, state.step)
        print("final losses: " + " ".join(f"{k}: {v:.3f}" for k, v in host.items()))
    distributed.check_replicated(nets, f"networks at step {state.step}")
    return state, cfg


def _from_rank0(avg, dev):
    """Rank 0's eval averages on every rank (one broadcast); the identity in
    one process."""
    if not distributed.is_multiprocess() or not avg:
        return avg
    vals = torch.tensor([avg[k] for k in sorted(avg)], dtype=torch.float64, device=dev)
    torch.distributed.broadcast(vals, 0)
    return dict(zip(sorted(avg), vals.tolist()))


def _check_finite(losses, step):
    host = {k: float(v) for k, v in losses.items()}
    bad = [k for k, v in host.items() if not math.isfinite(v)]
    if bad:
        # stop rather than burn epochs on a diverged run
        raise FloatingPointError(f"non-finite losses at step {step}: {bad}")
    return host
