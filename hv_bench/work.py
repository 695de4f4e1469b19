"""The yardstick's arithmetic: the card's peaks, the attention's operations
and bytes, and the operations and bytes of the plain reference counted at
a configuration's shapes.

Every share the benchmark reports divides work counted here by a time
measured on the card, so that the same work reads the same whatever
implements it.

    python -m hv_bench.work --config hv_bench/configs/<name>.json

prints the counts that belong in the configuration's "work" entry (a CPU
run, a few seconds); a CPU test recomputes them.
"""

from __future__ import annotations

import argparse
import json

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

# NVIDIA H100 SXM data sheet, dense: bf16 tensor cores; TF32 tensor cores
# (the float32 work's peak whatever implements it: cuDNN's float32 convs
# run on the CUDA cores at 67 TFLOP/s, the float32 attention in 3xTF32 on
# the tensor cores); HBM3.
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 495e12}
PEAK_BYTES = 3.35e12
ESIZE = {"bfloat16": 2, "float32": 4}
CONV_OPS = ("convolution", "_convolution", "convolution_backward")


def least_s(flops, nbytes, dtype):
    """Least seconds for `flops` at the dtype's peak and `nbytes` at the
    memory rate: the larger of the two."""
    return max(flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES)


def attention_fwd(b, hd, wd, c, dtype):
    """(operations, bytes) of one contextual-attention forward over b
    samples: the 3 x 3 score product and the 4 x 4 paste, L * P * C deep
    each; inputs read once (fd, bd, b_full, the gate) and y written once."""
    num_l = hd * wd
    flops = b * (9 * 2 * num_l * num_l * c + 16 * 2 * num_l * num_l * c)
    e = ESIZE[dtype]
    nbytes = b * (2 * num_l * c * e + 4 * num_l * c * e + num_l * 4 + 4 * num_l * c * e)
    return flops, nbytes


def attention_bwd(b, hd, wd, c, dtype):
    """(operations, bytes) of one backward: the two paste adjoints (16
    shifted products each) and the two score adjoints (9 each); fd, bd,
    b_full, dy and the three gradients in the input type, s and probs (L, P)
    and nrm_raw and the gate (L) in float32."""
    num_l = hd * wd
    flops = b * 2 * (16 + 16 + 9 + 9) * num_l * num_l * c
    e = ESIZE[dtype]
    nbytes = b * ((2 + 8 + 2 + 4) * num_l * c * e + 2 * num_l * num_l * 4 + 2 * num_l * 4)
    return flops, nbytes


def attention_grid(image_size, ngf):
    """(hd, wd, c) of the generator's attention at an image size: the
    features at 1/4 with 4 * ngf channels, matched at 1/8."""
    return image_size // 8, image_size // 8, 4 * ngf


class Counter(TorchDispatchMode):
    """Operations (torch's flop formulas) and elements read and written by
    every op that has a formula, split into convolutions and the rest."""

    def __init__(self):
        super().__init__()
        self.flops = {"conv": 0, "other": 0}
        self.elems = {"conv": 0, "other": 0}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        pkt = func._overloadpacket
        if pkt in flop_registry:
            kind = "conv" if pkt.__name__ in CONV_OPS else "other"
            self.flops[kind] += int(flop_registry[pkt](*args, **kwargs, out_val=out))
            flat = list(args) + list(kwargs.values())
            flat += list(out) if isinstance(out, (tuple, list)) else [out]
            self.elems[kind] += sum(t.numel() for t in flat if isinstance(t, torch.Tensor))
        return out


def _batch(size, gen):
    """A batch of one training example's shapes (the values do not change
    the counts)."""
    g = lambda *s: torch.rand(s, generator=gen)
    mask = torch.zeros(1, size, size, 1)
    mask[:, size // 2 - 20:size // 2 + 21] = 1.0
    return dict(context=g(1, size, size, 1) * 2 - 1, mask=mask, cam=g(1, size, size, 1),
                full=g(1, size, size, 1) * 2 - 1, vert_seg=(g(1, size, size, 1) > 0.5).float(),
                normal_vert=(g(1, size, size, 1) > 0.5).float(),
                slice_ratio=torch.tensor([0.2]), height=torch.tensor([26]),
                x1=torch.tensor([size // 2 - 13]), x2=torch.tensor([size // 2 + 13]))


def count(config: dict) -> dict:
    """The configuration's work at its shapes, counted on the CPU from the
    plain reference at batch 1: one generator forward (a slice of the 3D
    synthesis) and one training step (an example of the training cells)."""
    from .reference import model as ref

    m = config["model"]
    torch.manual_seed(0)
    nets = ref.Nets(m["ngf"], m["ndf"], m["n_layers_D"])
    for mod in nets.gen.modules():
        if isinstance(mod, ref.SNConv):
            torch.nn.init.normal_(mod.weight, std=0.05)
    batch = _batch(m["image_size"], torch.Generator().manual_seed(0))
    fwd = Counter()
    with torch.no_grad(), fwd:
        nets.gen(batch["context"], batch["mask"], 1.0 - batch["cam"], batch["slice_ratio"])
    opts = [torch.optim.Adam(n.parameters(), lr=0.0) for n in (nets.gen, nets.d1, nets.d2, nets.d3)]
    step = Counter()
    with step:
        ref.train_step(nets, opts, batch, 0.0, {"image_size": m["image_size"],
                                                "lambda_L1": m["lambda_L1"]})
    return {"slice_fwd_flops": sum(fwd.flops.values()),
            "slice_fwd_conv_flops": fwd.flops["conv"],
            "example_flops": sum(step.flops.values()),
            "example_conv_flops": step.flops["conv"],
            "example_conv_elems": step.elems["conv"]}


def main(argv=None):
    ap = argparse.ArgumentParser(description="work counts of a configuration file")
    ap.add_argument("--config", required=True)
    args = ap.parse_args(argv)
    with open(args.config) as f:
        print(json.dumps(count(json.load(f)), indent=1))


if __name__ == "__main__":
    main()
