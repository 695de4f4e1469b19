"""Training CLI of the port: the counterpart of the root train.py.

    python -m healthivert_tpu_torch.cli.train --dataroot ./datasets/straightened \\
        --name exp --model pix2pix --direction BtoA --batch_size 16 --n_epochs 1000

Checkpoints go to {checkpoints_dir}/{name}/{tag}.pt ('latest', each
save_epoch_freq-th epoch, and iter_N under --save_by_iter); --continue_train
resumes from --epoch (or --load_iter N). Hermetic run without data: add
--dataset_mode synthetic. Runs on the card of --gpu_ids (default 0);
--gpu_ids -1 runs on the CPU.

Data-parallel on N cards, one process a card, --batch_size the global batch:

    torchrun --standalone --nproc_per_node N -m healthivert_tpu_torch.cli.train \
        --gpu_ids 0,1,...,N-1 --batch_size 32 ...

Each process takes the card of --gpu_ids at its LOCAL_RANK and joins the
process group over NCCL (gloo with --gpu_ids -1). --mesh data:-1 (the
default) is the world size; a mesh must span the world. --mesh
data:-1,model:2 lays the N processes out as N/2 data shards x 2 model
replicas, the JAX package's model axis: the replicas of a shard train on the
same slice of the batch with the same weights, so the step is that of N/2
data shards.
"""

from __future__ import annotations

import math
import sys

from ..config.options import TestOptions, TrainOptions
from ..engine.train_loop import run_training
from ..parallel import distributed
from ..parallel.mesh import mesh_shape
from ..utils.device import float32_exact
from .common import load_npz_parser, options_with


def parse_profile_steps(spec):
    """--profile_steps START[,STOP] (STOP defaults to START + 10)."""
    if not spec:
        return None
    a, _, b = spec.partition(",")
    try:
        start = int(a)
        stop = int(b) if b else start + 10
    except ValueError:
        raise SystemExit(f"--profile_steps expects START[,STOP] integers, got {spec!r}")
    if start < 0 or stop <= start:
        raise SystemExit(f"--profile_steps needs 0 <= START < STOP, got {start},{stop}")
    return start, stop


def check_mesh(spec, world):
    """Exit unless --mesh spans the world: data x model processes (an axis
    of -1 takes what the others leave)."""
    shape = mesh_shape(spec, world)
    n = math.prod(max(s, 1) for s in shape.values())
    if n != world:
        raise SystemExit(
            f"--mesh {spec} asks for {n} processes ({shape}), but {world} run: the "
            "train CLI runs one process per mesh position; start it as torchrun "
            f"--standalone --nproc_per_node {n} -m healthivert_tpu_torch.cli.train ... "
            "with one card a process in --gpu_ids")


def main(argv=None):
    float32_exact()
    pre = load_npz_parser()
    ns, rest = pre.parse_known_args(argv)
    opt = options_with(pre, TrainOptions).parse(rest)
    opt.load_npz = ns.load_npz
    check_mesh(opt.mesh, distributed.ensure_initialized(device=opt.device))

    # second parse for the in-training eval split (reference train.py:173-177);
    # known_only: ignore train-only flags when re-parsing for the eval split
    opt_test = TestOptions().parse(rest, save=False, known_only=True)
    opt_test.batch_size = 5
    opt_test.serial_batches = True
    opt_test.phase = "test"
    opt_test.isTrain = False
    return run_training(opt, opt_test, max_steps=getattr(opt, "max_steps", None),
                        profile_steps=parse_profile_steps(getattr(opt, "profile_steps", None)),
                        device=opt.device)


if __name__ == "__main__":
    try:
        main(sys.argv[1:])
    finally:
        distributed.shutdown()
