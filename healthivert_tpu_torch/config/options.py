"""Layered CLI option system of the port's entry points.

A copy of healthivert_tpu/config/options.py:21-292: the same flags,
defaults and help (three help texts name the port's own means: --load_pth
is read with torch.load, --profile_steps writes a torch.profiler trace,
--int8_calib names the port's int8 scale store), the
plugin flag injection of the model and dataset
registries, and the resolved-options dump to
{checkpoints_dir}/{name}/{phase}_opt.txt, byte for byte as the JAX package
writes it. Help texts that speak of the TPU are kept as they are: they name
the flags' meaning in the JAX package, whose checkpoints and recipes these
options reproduce.

Where the JAX package selects a JAX backend, the port resolves a torch
device: --gpu_ids -1 selects the CPU (the reference's semantics), an id >= 0
selects that CUDA card and raises when there is none. Several ids are the
cards of a run: under torchrun each process takes the id at its LOCAL_RANK,
and the 3D synthesis CLI shards its slice batches over all of them. An
--lr_policy that neither package runs raises NotImplementedError when it is
used (`check_ported`).
"""

from __future__ import annotations

import argparse
import os

import torch


def _base_parser(parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
    # basic parameters (base_options.py:21-27)
    parser.add_argument("--dataroot", required=False, default=None,
                        help="path to straightened dataset (CT/ label/ subdirs)")
    parser.add_argument("--name", type=str, default="experiment_name")
    parser.add_argument("--gpu_ids", type=str, default="0",
                        help="-1 = run on CPU (reference semantics); ids >= 0 "
                             "keep the default accelerator platform")
    parser.add_argument("--checkpoints_dir", type=str, default="./checkpoints")
    # model parameters
    parser.add_argument("--model", type=str, default="pix2pix")
    parser.add_argument("--input_nc", type=int, default=1)
    parser.add_argument("--output_nc", type=int, default=1)
    parser.add_argument("--ngf", type=int, default=64)
    parser.add_argument("--ndf", type=int, default=64)
    parser.add_argument("--netD", type=str, default="basic")
    parser.add_argument("--netG", type=str, default="unet_256")
    parser.add_argument("--n_layers_D", type=int, default=3)
    parser.add_argument("--norm", type=str, default="instance")
    parser.add_argument(
        "--init_type", type=str, default="normal",
        choices=["normal", "xavier", "kaiming", "orthogonal"],
    )
    parser.add_argument("--init_gain", type=float, default=0.02)
    parser.add_argument("--no_dropout", action="store_true")
    # dataset parameters
    parser.add_argument("--dataset_mode", type=str, default="aligned")
    parser.add_argument("--direction", type=str, default="AtoB")
    parser.add_argument("--serial_batches", action="store_true")
    parser.add_argument("--num_threads", default=16, type=int)
    parser.add_argument("--batch_size", type=int, default=12)
    parser.add_argument("--load_size", type=int, default=256)
    parser.add_argument("--crop_size", type=int, default=256)
    parser.add_argument("--max_dataset_size", type=int, default=2**31)
    parser.add_argument("--preprocess", type=str, default="none")
    parser.add_argument("--no_flip", action="store_true")
    parser.add_argument("--display_winsize", type=int, default=256)
    # additional parameters
    parser.add_argument("--epoch", type=str, default="latest")
    parser.add_argument("--load_iter", type=int, default=0)
    parser.add_argument("--load_pth", type=str, default=None,
                        help="path to a reference torch .pth generator state dict "
                             "to ingest (torch.load(weights_only=True); utils/pth.py). During "
                             "training, sibling *_net_D_{1,2,3}.pth files are "
                             "loaded too when present (load_networks parity)")
    parser.add_argument("--verbose", action="store_true")
    parser.add_argument("--suffix", default="", type=str)
    parser.add_argument("--use_wandb", action="store_true")
    parser.add_argument("--wandb_project_name", type=str, default="HealthiVert-TPU")
    # TPU-native parameters
    parser.add_argument("--mesh", type=str, default="data:-1",
                        help="device mesh spec 'axis:n[,axis:n]'; n=-1 uses all devices")
    parser.add_argument("--compute_dtype", type=str, default="float32",
                        choices=["float32", "bfloat16", "int8"],
                        help="int8 = post-training-quantized generator convs "
                             "(inference only; int8 x int8 products summed "
                             "in int32)")
    parser.add_argument("--int8_calib", type=str, default="auto",
                        choices=["auto", "dynamic"],
                        help="int8 activation scales: 'auto' calibrates "
                             "static per-tensor percentile scales (the "
                             "99.5th; see pix2pix.INT8_CALIB_PERCENTILE) "
                             "from the first batch; eval_3d persists them to "
                             "{checkpoints_dir}/{name}/int8_quant.pt, "
                             "fingerprinted to the weights, and reuses the "
                             "file, so outputs don't depend on batch "
                             "grouping/--slice_batch (delete it to "
                             "recalibrate; the JAX package's .msgpack store "
                             "is not read); 'dynamic' keeps per-sample "
                             "absmax scales (batch-invariant by "
                             "construction)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--gan_head_preupdate",
                        action=argparse.BooleanOptionalAction, default=True,
                        help="G GAN terms vs PRE-update discriminators (XLA "
                             "CSEs the D(fake) forwards out of the G head: "
                             "+4%% train throughput @bs128 on v5e; quality "
                             "validated at the 1000-step recipe, r5). "
                             "Default ON; --no-gan_head_preupdate restores "
                             "the reference's exact update order (D first, "
                             "G against the updated Ds)")
    parser.add_argument("--crop_d3",
                        action=argparse.BooleanOptionalAction, default=True,
                        help="feed D3 a static 48x128 crop around the band "
                             "mask instead of the full frame (its input is "
                             "nonzero on <=41x70 px; the crop provably "
                             "contains all of it at ~1/10 the PatchGAN "
                             "FLOPs: +17%% train throughput @bs128, quality "
                             "validated at the 1000-step recipe, r5). "
                             "Default ON; --no-crop_d3 restores the "
                             "reference's full-frame D3 (undiluted "
                             "patch-loss mean + BatchNorm stats are the "
                             "deviation)")
    parser.add_argument("--remat", action="store_true",
                        help="rematerialize the generator forward in the backward "
                             "(jax.checkpoint): fits larger train batches for ~one "
                             "extra G forward per step")
    parser.add_argument("--cam_dir", type=str, default=None,
                        help="folder of HGAM attention heatmap NIfTIs; omit for uniform CAM")
    parser.add_argument("--synthetic_cache", type=int, default=0,
                        help="pre-build N synthetic examples (amortizes host sampling)")
    parser.add_argument("--data_cache_gb", type=float, default=4.0,
                        help="LRU cache of decompressed vertebra volumes (uint8), "
                             "GB PER DATASET — training holds a train + an eval "
                             "dataset, so worst-case host RSS is ~2x this; 0 "
                             "disables. Each 1-slice example otherwise gunzips "
                             "2-3 full volumes")
    return parser


def _train_parser(parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
    # train_options.py:12-39
    parser.add_argument("--display_freq", type=int, default=400)
    parser.add_argument("--display_ncols", type=int, default=4)
    parser.add_argument("--display_id", type=int, default=1)
    parser.add_argument("--display_server", type=str, default="http://localhost")
    parser.add_argument("--display_env", type=str, default="main")
    parser.add_argument("--display_port", type=int, default=8097)
    parser.add_argument("--update_html_freq", type=int, default=1000)
    parser.add_argument("--print_freq", type=int, default=100)
    parser.add_argument("--no_html", action="store_true")
    parser.add_argument("--save_latest_freq", type=int, default=5000)
    parser.add_argument("--save_epoch_freq", type=int, default=5)
    parser.add_argument("--save_by_iter", action="store_true")
    parser.add_argument("--continue_train", action="store_true")
    parser.add_argument("--epoch_count", type=int, default=1)
    parser.add_argument("--phase", type=str, default="train")
    parser.add_argument("--n_epochs", type=int, default=200)
    parser.add_argument("--n_epochs_decay", type=int, default=800)
    parser.add_argument("--beta1", type=float, default=0.5)
    parser.add_argument("--lr", type=float, default=0.0002)
    parser.add_argument("--gan_mode", type=str, default="wgangp")
    parser.add_argument("--pool_size", type=int, default=50)
    parser.add_argument("--lr_policy", type=str, default="linear")
    parser.add_argument("--lr_decay_iters", type=int, default=50)
    parser.add_argument("--vert_class", type=str, default="normal")
    parser.add_argument("--eval_freq", type=int, default=15,
                        help="run in-training eval every N epochs (train.py:224)")
    parser.add_argument("--max_steps", type=int, default=None,
                        help="stop after N optimization steps (bounded "
                             "validation runs; default: run the full "
                             "epoch schedule)")
    parser.add_argument("--profile_steps", type=str, default=None,
                        help="'START,STOP' step numbers bracketing a "
                             "torch.profiler trace written to "
                             "{checkpoints_dir}/{name}/profile "
                             "(SURVEY.md §5: tracing wired into the loop); "
                             "the program's spans of those steps go beside "
                             "it as spans.json")
    return parser


def _test_parser(parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
    # test_options.py:11-22
    parser.add_argument("--results_dir", type=str, default="./results/")
    parser.add_argument("--aspect_ratio", type=float, default=1.0)
    parser.add_argument("--phase", type=str, default="test")
    parser.add_argument("--eval", action="store_true")
    parser.add_argument("--num_test", type=int, default=1000)
    parser.add_argument("--vert_class", type=str, default="normal")
    return parser


LR_POLICIES = ("linear", "step", "plateau", "cosine")


def gpu_id_list(gpu_ids):
    """The ids >= 0 of --gpu_ids, in order; strict, as the reference's int()
    loop: a typo must error, not silently fall back to the CPU."""
    try:
        ids = [int(t) for t in str(gpu_ids).split(",") if t.strip()]
    except ValueError:
        raise SystemExit(f"--gpu_ids expects comma-separated integers, got {gpu_ids!r}")
    return [i for i in ids if i >= 0]


def device_from_gpu_ids(gpu_ids) -> torch.device:
    """The device of --gpu_ids: the CPU when no id is >= 0 (the reference's
    semantics, base_options.py:131-139), else ``cuda:<id>`` for the id at
    this process's LOCAL_RANK (torchrun's; 0 without it), which raises when
    there is no card."""
    ids = gpu_id_list(gpu_ids)
    if not ids:
        return torch.device("cpu")
    local_rank = int(os.environ.get("LOCAL_RANK", "0"))
    if local_rank >= len(ids):
        raise SystemExit(
            f"--gpu_ids {gpu_ids} names {len(ids)} card(s) but this is local process "
            f"{local_rank}: give one id per process of torchrun --nproc_per_node")
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"--gpu_ids {gpu_ids} selects cuda:{ids[local_rank]}, but "
            "torch.cuda.is_available() is False; pass --gpu_ids -1 to run on the CPU"
        )
    return torch.device(f"cuda:{ids[local_rank]}")


def check_ported(opt) -> None:
    """Raise NotImplementedError for a flag that neither package runs: an
    --lr_policy outside the LRSchedule's."""
    if opt.isTrain and getattr(opt, "lr_policy", "linear") not in LR_POLICIES:
        raise NotImplementedError(
            f"not ported: --lr_policy {opt.lr_policy} (the port's LRSchedule runs "
            f"{', '.join(LR_POLICIES)}, as the JAX package's; see ROADMAP.md)")


class BaseOptions:
    """Gathers base + model/dataset-injected flags, prints and persists them."""

    isTrain: bool = False
    epilog = None

    def initialize(self, parser):
        return _base_parser(parser)

    def gather_options(self, args=None, known_only: bool = False):
        parser = argparse.ArgumentParser(
            formatter_class=argparse.ArgumentDefaultsHelpFormatter,
            epilog=self.epilog,
        )
        parser = self.initialize(parser)
        opt, _ = parser.parse_known_args(args)

        # plugin flag injection, as base_options.py:79-88
        from ..data import get_option_setter as data_setter
        from ..models import get_option_setter as model_setter

        parser = model_setter(opt.model)(parser, self.isTrain)
        opt, _ = parser.parse_known_args(args)
        parser = data_setter(opt.dataset_mode)(parser, self.isTrain)

        self.parser = parser
        if known_only:
            opt, _ = parser.parse_known_args(args)
            return opt
        return parser.parse_args(args)

    def print_options(self, opt, save: bool = True) -> str:
        lines = ["----------------- Options ---------------"]
        for k, v in sorted(vars(opt).items()):
            comment = ""
            default = self.parser.get_default(k)
            if v != default:
                comment = f"\t[default: {default}]"
            lines.append(f"{str(k):>25}: {str(v):<30}{comment}")
        lines.append("----------------- End -------------------")
        message = "\n".join(lines)
        print(message)
        # under torchrun the processes share the run dir: rank 0 writes it
        if save and int(os.environ.get("RANK", "0")) == 0:
            expr_dir = os.path.join(opt.checkpoints_dir, opt.name)
            os.makedirs(expr_dir, exist_ok=True)
            with open(os.path.join(expr_dir, f"{opt.phase}_opt.txt"), "w") as f:
                f.write(message + "\n")
        return message

    def parse(self, args=None, save: bool = True, known_only: bool = False):
        opt = self.gather_options(args, known_only=known_only)
        opt.isTrain = self.isTrain
        if opt.suffix:
            opt.name = opt.name + "_" + opt.suffix.format(**vars(opt))
        check_ported(opt)
        device = device_from_gpu_ids(opt.gpu_ids)
        self.print_options(opt, save=save)
        # set after the dump, so that {phase}_opt.txt stays the JAX package's
        opt.device = device
        return opt


class TrainOptions(BaseOptions):
    isTrain = True

    def initialize(self, parser):
        return _train_parser(_base_parser(parser))


class TestOptions(BaseOptions):
    isTrain = False

    def initialize(self, parser):
        parser = _test_parser(_base_parser(parser))
        parser.set_defaults(load_size=parser.get_default("crop_size"))
        # inference CLIs default to bf16 convs like eval_3d_sagittal_twostage
        # (training keeps the reference's f32 default); --compute_dtype
        # float32 still forces true-f32 everywhere. Guards the silent
        # f32-convs-on-TPU bug class caught in bench/infer3d (r3)
        parser.set_defaults(compute_dtype="bfloat16")
        return parser
