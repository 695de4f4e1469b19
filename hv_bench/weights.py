"""Seeded weights of the generator and the three discriminators, made by
the benchmark on the device in one draw and handed alike to the system
under test and to the plain reference.

The distributions are the published initialisations: the generator's
kernels at variance 1 / fan_in (flax's lecun normal, untruncated), its
biases zero and its spectral-norm vectors l2-normalised normals; the
discriminators' kernels N(0, 0.02), their BatchNorm scales N(1, 0.02),
biases zero, running statistics 0 and 1.
"""

from __future__ import annotations

import math

import torch


def _std(key: str, shape) -> tuple:
    """(mean, std) of a drawn entry, or None for a constant one."""
    name = key.rsplit(".", 1)[-1]
    if key.startswith("gen."):
        if name == "weight":
            return 0.0, 1.0 / math.sqrt(math.prod(shape[1:]))
        if name == "u":
            return 0.0, 1.0
        return None
    if name == "weight" and len(shape) == 4:
        return 0.0, 0.02
    if name == "weight" and key.split(".")[1].startswith("norm"):
        return 1.0, 0.02
    return None


def make(template: dict, seed: int, device) -> dict:
    """{key: float32 tensor on device} for every entry of `template`
    (a state dict of the reference's `Nets`), drawn from `seed`."""
    gen = torch.Generator(device=device).manual_seed(seed)
    drawn = [(k, t.shape, _std(k, t.shape)) for k, t in template.items()]
    total = sum(math.prod(s) for _, s, d in drawn if d is not None)
    flat = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for k, shape, d in drawn:
        if d is None:
            if k.endswith("running_var"):
                out[k] = torch.ones(shape, device=device)
            else:
                out[k] = torch.zeros(shape, device=device)
            continue
        n = math.prod(shape)
        t = flat[at:at + n].reshape(shape) * d[1] + d[0]
        at += n
        if k.endswith(".u"):
            t = t / (torch.linalg.vector_norm(t) + 1e-12)
        out[k] = t.contiguous()
    return out
