"""Checkpoints of the port: the full training state, the generator alone,
the exported ``.npz`` and the reference's ``.pth`` files.

Counterpart of healthivert_tpu/engine/checkpoint.py. The JAX package keeps
orbax directories ``{run_dir}/{tag}/``, which need JAX to read; the port
keeps one `torch.save` file per tag, ``{run_dir}/{tag}.pt``, so the two
never collide. A full checkpoint holds the step, the four networks' state
dicts (the generator's spectral-norm u vectors and the discriminators'
BatchNorm running statistics are buffers there) and the four Adam states;
a generator-only one holds the generator's state dict. Each file is written
to a temporary name and moved into place (`os.replace`), so a crash never
leaves a torn checkpoint. Under a process group of several ranks, whose
states are replicas, rank 0 writes the file and every rank then meets at a
barrier; a resume reads the file on every rank.

The fracture classifier (HGAM) is kept as ``{out}/classifier.pt`` beside
the ``meta.json`` its CLI writes; the JAX package's CLI keeps an orbax
``{out}/classifier/`` there instead.

The shipped `checkpoints/pretrained_synthetic/generator` is orbax; its trees
are exported once to `weights/pretrained_synthetic_generator.npz`
(tests/test_torch_weights.py holds the two equal and writes the file), which
`load_generator` and the CLIs' --load_npz read.
"""

from __future__ import annotations

import os
from pathlib import Path

import torch

from ..models.generator import Generator
from ..models.pix2pix import Pix2PixConfig, TrainState, build_generator
from ..parallel import distributed
from ..utils.device import resolve_device
from ..utils.pth import load_discriminator_pth, load_generator_pth
from ..utils.weights import load_npz_state_dict

PRETRAINED_NPZ = (
    Path(__file__).resolve().parents[1] / "weights" / "pretrained_synthetic_generator.npz"
)
NETS = ("gen", "d1", "d2", "d3")
OPTS = ("opt_g", "opt_d1", "opt_d2", "opt_d3")


def load_generator(npz_path=PRETRAINED_NPZ, cfg: Pix2PixConfig = Pix2PixConfig(),
                   device="cuda") -> Generator:
    """A ready `Generator` (eval mode, on `device`) with the weights of an
    exported ``.npz``; its conv dtype follows cfg.compute_dtype."""
    dev = resolve_device(device)
    gen = build_generator(cfg)
    gen.load_state_dict(load_npz_state_dict(npz_path))
    return gen.to(dev).eval()


def checkpoint_path(run_dir, tag) -> str:
    return os.path.join(os.path.abspath(run_dir), f"{tag}.pt")


def _write(obj, run_dir, tag) -> str:
    path = checkpoint_path(run_dir, tag)
    if distributed.process_index() == 0:
        os.makedirs(run_dir, exist_ok=True)
        tmp = path + ".tmp"
        torch.save(obj, tmp)
        os.replace(tmp, path)
    distributed.barrier()
    return path


def _read(run_dir, tag, device):
    return torch.load(checkpoint_path(run_dir, tag), map_location=device, weights_only=True)


def save_checkpoint(state: TrainState, run_dir, tag="latest") -> str:
    """Write the whole training state to {run_dir}/{tag}.pt."""
    obj = {"kind": "train_state", "step": int(state.step)}
    obj.update({k: getattr(state, k).state_dict() for k in NETS + OPTS})
    return _write(obj, run_dir, tag)


def restore_checkpoint(state: TrainState, run_dir, tag="latest") -> TrainState:
    """Load {run_dir}/{tag}.pt into `state` (same configuration), in place."""
    obj = _read(run_dir, tag, next(state.gen.parameters()).device)
    if obj.get("kind") != "train_state":
        raise ValueError(f"{checkpoint_path(run_dir, tag)} holds no training state")
    for k in NETS + OPTS:
        getattr(state, k).load_state_dict(obj[k])
    state.step = int(obj["step"])
    return state


def save_generator(state: TrainState, run_dir, tag="generator") -> str:
    """Write the generator alone (the shippable artifact) to {run_dir}/{tag}.pt."""
    return _write({"kind": "generator", "gen": state.gen.state_dict()}, run_dir, tag)


def restore_generator(gen: Generator, run_dir, tag="generator") -> Generator:
    """Load the generator of {run_dir}/{tag}.pt, a generator-only or a full
    checkpoint, into `gen`."""
    gen.load_state_dict(_read(run_dir, tag, next(gen.parameters()).device)["gen"])
    return gen


def latest_exists(run_dir, tag="latest") -> bool:
    return os.path.isfile(checkpoint_path(run_dir, tag))


def orbax_exists(run_dir, tag) -> bool:
    """True when {run_dir}/{tag}/ is a JAX package (orbax) checkpoint."""
    return os.path.isdir(os.path.join(os.path.abspath(run_dir), str(tag)))


def resolve_tag(opt) -> str:
    """Checkpoint tag from CLI flags: `--load_iter N` (>0) selects the
    `iter_N` checkpoint written by `--save_by_iter`, else `--epoch`
    (load_networks parity, reference models/base_model.py:82-88)."""
    load_iter = getattr(opt, "load_iter", 0) or 0
    return f"iter_{load_iter}" if load_iter > 0 else str(opt.epoch)


def orbax_error(run_dir, tag) -> RuntimeError:
    return RuntimeError(
        f"{run_dir}/{tag}/ is a checkpoint of the JAX package (orbax), which "
        "the port cannot read; pass --load_npz with the generator exported to "
        f".npz (the shipped one: {PRETRAINED_NPZ})"
    )


def save_classifier(model, out_dir) -> str:
    """Write the fracture classifier's state dict to {out_dir}/classifier.pt."""
    return _write({"kind": "classifier", "classifier": model.state_dict()}, out_dir, "classifier")


def restore_classifier(model, out_dir):
    """Load {out_dir}/classifier.pt into `model`. A directory that holds only
    the JAX package's orbax classifier/ raises."""
    if not latest_exists(out_dir, "classifier") and orbax_exists(out_dir, "classifier"):
        raise RuntimeError(
            f"{out_dir}/classifier/ is a checkpoint of the JAX package (orbax), which "
            "the port cannot read; restore it with the JAX package and carry its params "
            "across with healthivert_tpu_torch.utils.weights.flax_classifier_to_state_dict, "
            "then save_classifier"
        )
    obj = _read(out_dir, "classifier", next(model.parameters()).device)
    if obj.get("kind") != "classifier":
        raise ValueError(f"{checkpoint_path(out_dir, 'classifier')} holds no classifier")
    model.load_state_dict(obj["classifier"])
    return model


def restore_generator_pth(gen: Generator, pth_path) -> Generator:
    """Overlay a reference torch .pth generator checkpoint onto `gen`."""
    n = load_generator_pth(pth_path, gen)
    print(f"loaded {n} generator tensors from {pth_path}")
    return gen


def restore_full_pth(state: TrainState, g_pth_path, n_layers_d: int = 3) -> TrainState:
    """Reference-checkpoint training resume: `{epoch}_net_G.pth` plus any
    sibling `{epoch}_net_D_{1,2,3}.pth` (load_networks semantics, reference
    models/base_model.py:189-212). Missing D files are skipped with a
    notice."""
    restore_generator_pth(state.gen, g_pth_path)
    g_dir, g_base = os.path.split(g_pth_path)
    if "_net_G" not in g_base:
        return state
    for i in (1, 2, 3):
        # replace on the basename only: a run directory containing '_net_G'
        # must not corrupt the sibling paths
        d_path = os.path.join(g_dir, g_base.replace("_net_G", f"_net_D_{i}"))
        if not os.path.exists(d_path):
            print(f"no discriminator checkpoint {d_path}; keeping initialized D_{i}")
            continue
        n = load_discriminator_pth(d_path, getattr(state, f"d{i}"), n_layers=n_layers_d)
        print(f"loaded {n} discriminator tensors from {d_path}")
    return state


def generator_for_cli(opt, cfg: Pix2PixConfig, device, load_npz=None) -> Generator:
    """The generator of an inference CLI (test, 3D synthesis), eval mode on
    `device`. Weight precedence: --load_pth, the port checkpoint
    {run_dir}/{tag}.pt, the generator-only {run_dir}/generator.pt, then
    --load_npz. A run directory with only a JAX package checkpoint raises;
    with none at all, the generator keeps its seeded initialisation and a
    warning says so, as the JAX package's CLIs do."""
    from ..models.generator import init_generator

    gen = build_generator(cfg)
    init_generator(gen, torch.Generator().manual_seed(opt.seed))
    gen.to(device).eval()
    run_dir = os.path.join(opt.checkpoints_dir, opt.name)
    tag = resolve_tag(opt)  # --load_iter N > 0 picks iter_N
    if getattr(opt, "load_pth", None):
        restore_generator_pth(gen, opt.load_pth)
    elif latest_exists(run_dir, tag):
        restore_generator(gen, run_dir, tag)
        print(f"loaded checkpoint {checkpoint_path(run_dir, tag)}")
    elif latest_exists(run_dir, "generator"):
        restore_generator(gen, run_dir)
        print(f"loaded generator-only checkpoint {checkpoint_path(run_dir, 'generator')}")
    elif load_npz:
        gen.load_state_dict(load_npz_state_dict(load_npz))
        print(f"loaded generator from {load_npz}")
    elif orbax_exists(run_dir, tag) or orbax_exists(run_dir, "generator"):
        raise orbax_error(run_dir, tag if orbax_exists(run_dir, tag) else "generator")
    else:
        print(f"warning: no checkpoint at {checkpoint_path(run_dir, tag)}; using init weights")
    return gen
