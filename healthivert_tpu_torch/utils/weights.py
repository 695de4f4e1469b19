"""Carry generator and discriminator weights from the JAX package's flax
trees to this port.

The flax generator stores {"params", "sn"} trees: conv kernels HWIO under
``<stage>/<block>/conv/kernel`` with ``bias`` beside them, Dense kernels
(in, out) under ``<stage>/fc_height/kernel``, and the spectral-norm vectors
under ``sn/<stage>/<block>/conv/u``. This is the inverse of
healthivert_tpu/utils/pth.py `map_generator_state` (:234): conv kernels go
HWIO -> OIHW, Dense kernels are transposed, u is carried over.

The flax discriminators store {"params", "batch_stats"} trees: conv kernels
HWIO under ``conv<n>/kernel`` (``conv_out``, ``conv0``, ...) with ``bias``
beside them where there is one, BatchNorm ``norm<n>/scale`` and ``bias``,
and the running statistics ``batch_stats/norm<n>/mean`` and ``var``. They
become the state dict of `models.discriminator`: kernels OIHW, scale and
bias the norm's weight and bias, mean and var its running_mean and
running_var.

The legacy networks (models/legacy.py) store the same kinds of variables
under their flax names; their nn.ConvTranspose kernels (kh, kw, in, out)
become torch's transposed-conv layout (in, out, kh, kw), flipped in space.

The flax fracture classifier (HGAM) stores {"params"}: ``conv<i>/kernel``
HWIO and ``bias``, GroupNorm ``gn<i>/scale`` and ``bias``, and the head
``fc/kernel`` (in, out) and ``bias``. They become the state dict of
`models.hgam.FractureClassifier`: ``convs.<i>``, ``norms.<i>`` and ``fc``.

The int8 calibration trees of the flax generator (its "calib" collection,
``<stage>/<block>/conv/act_absmax`` and ``act_pq``) and the static scale
trees made from them (``.../conv/act_scale``) become the port's flat dicts
keyed by the conv's module path (``<stage>.<block>.conv``), the same path
its weight takes in the state dict.

The trees arrive as nested dicts of numpy arrays, or as a flat ``.npz``
whose keys are the tree paths joined by "/" (``params/coarse_generator/
conv1/conv/kernel``, ``sn/.../u``).
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch


def flatten_tree(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dict -> {"a/b/c": array}."""
    out: Dict[str, np.ndarray] = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.update(flatten_tree(v, key + "/"))
        else:
            out[key] = np.asarray(v)
    return out


def unflatten_tree(flat: Mapping[str, np.ndarray]) -> dict:
    """{"a/b/c": array} -> nested dict."""
    tree: dict = {}
    for key, v in flat.items():
        node = tree
        *parents, leaf = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = np.asarray(v)
    return tree


def flax_to_state_dict(params: Mapping, sn: Mapping) -> Dict[str, torch.Tensor]:
    """Flax generator trees -> state dict of `models.generator.Generator`."""
    sd: Dict[str, torch.Tensor] = {}
    for path, leaf in flatten_tree(params).items():
        *mod, name = path.split("/")
        a = np.asarray(leaf, np.float32)
        if name == "kernel" and a.ndim == 4:
            sd[".".join(mod + ["weight"])] = torch.from_numpy(
                np.array(a.transpose(3, 2, 0, 1), order="C"))
        elif name == "kernel" and a.ndim == 2:
            sd[".".join(mod + ["weight"])] = torch.from_numpy(np.array(a.T, order="C"))
        elif name == "bias":
            sd[".".join(mod + ["bias"])] = torch.from_numpy(a.copy())
        else:
            raise ValueError(f"unexpected generator parameter {path} {a.shape}")
    for path, leaf in flatten_tree(sn).items():
        *mod, name = path.split("/")
        if name != "u":
            raise ValueError(f"unexpected spectral-norm variable {path}")
        sd[".".join(mod + ["u"])] = torch.from_numpy(np.asarray(leaf, np.float32).copy())
    return sd


def _int8_leaves(tree: Mapping, names):
    """{(module path, leaf name): float32 tensor} of an int8 tree whose
    leaves are all in `names`."""
    out = {}
    for path, leaf in flatten_tree(tree).items():
        *mod, name = path.split("/")
        if name not in names or not mod:
            raise ValueError(f"unexpected int8 variable {path}")
        out[(".".join(mod), name)] = torch.from_numpy(np.array(leaf, np.float32))
    return out


def flax_calib_to_flat(calib: Mapping) -> Dict[str, Dict[str, torch.Tensor]]:
    """A flax "calib" tree -> the port's calib tree {path: {"act_absmax",
    "act_pq"}}."""
    out: Dict[str, Dict[str, torch.Tensor]] = {}
    for (mod, name), t in _int8_leaves(calib, ("act_absmax", "act_pq")).items():
        out.setdefault(mod, {})[name] = t
    return out


def flax_quant_to_flat(quant: Mapping) -> Dict[str, torch.Tensor]:
    """A flax "quant" tree -> the port's quant tree {path: act_scale}."""
    return {mod: t for (mod, _), t in _int8_leaves(quant, ("act_scale",)).items()}


def flax_discriminator_to_state_dict(params: Mapping,
                                     batch_stats: Mapping = None) -> Dict[str, torch.Tensor]:
    """Flax discriminator trees -> state dict of `models.discriminator`'s
    NLayerDiscriminator or PixelDiscriminator (their names hold no
    transposed conv, so the legacy bridge maps them)."""
    return flax_legacy_to_state_dict(params, batch_stats)


# the flax names of the legacy networks' nn.ConvTranspose layers: `_up`'s
# ``<name>_deconv``, the seg decoder's ``dec<i>`` and ``seg_out``, and
# ResnetGenerator's ``up<i>``
_TRANSPOSED = re.compile(r"(.*_deconv|dec\d+|seg_out|up\d+)")


def flax_legacy_to_state_dict(params: Mapping,
                              batch_stats: Mapping = None) -> Dict[str, torch.Tensor]:
    """Flax trees of a `models.legacy` network (SegDiscriminator,
    UnetGenerator, ResnetGenerator, DualHeadUNet) -> its state dict. Conv
    kernels go HWIO -> OIHW; ConvTranspose kernels (kh, kw, in, out), which
    flax does not flip, go to torch's (in, out, kh, kw) flipped in space
    (`legacy.ConvTranspose`); biases, BatchNorm scale and bias, and the
    running mean and var map as in flax_discriminator_to_state_dict."""
    sd: Dict[str, torch.Tensor] = {}
    names = {"kernel": "weight", "bias": "bias", "scale": "weight",
             "mean": "running_mean", "var": "running_var"}
    for path, leaf in [*flatten_tree(params).items(), *flatten_tree(batch_stats or {}).items()]:
        *mod, name = path.split("/")
        a = np.asarray(leaf, np.float32)
        if name not in names or (name == "kernel") != (a.ndim == 4):
            raise ValueError(f"unexpected discriminator or legacy network variable {path} "
                             f"{a.shape}")
        if name == "kernel":
            if _TRANSPOSED.fullmatch(mod[-1]):
                a = a[::-1, ::-1].transpose(2, 3, 0, 1)
            else:
                a = a.transpose(3, 2, 0, 1)
        sd[".".join(mod + [names[name]])] = torch.from_numpy(np.array(a, order="C"))
    return sd


def flax_classifier_to_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    """Flax classifier variables (or their "params" tree) -> state dict of
    `models.hgam.FractureClassifier`."""
    params = params.get("params", params)
    modules = {"conv": "convs.{}", "gn": "norms.{}", "fc": "fc"}
    names = {"kernel": "weight", "scale": "weight", "bias": "bias"}
    sd: Dict[str, torch.Tensor] = {}
    for path, leaf in flatten_tree(params).items():
        mod, name = path.split("/")
        a = np.asarray(leaf, np.float32)
        m = re.fullmatch(r"(conv|gn)(\d)|fc", mod)
        if not m or name not in names or (name == "scale") != (m.group(1) == "gn" and name != "bias"):
            raise ValueError(f"unexpected classifier variable {path} {a.shape}")
        if name == "kernel":
            a = a.transpose(3, 2, 0, 1) if a.ndim == 4 else a.T
        key = modules[m.group(1) or "fc"].format(m.group(2)) + "." + names[name]
        sd[key] = torch.from_numpy(np.array(a, order="C"))
    return sd


def load_npz_trees(path) -> tuple:
    """(params, sn) nested trees from a flat ``.npz`` keyed by tree path."""
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    trees = unflatten_tree(flat)
    return trees["params"], trees["sn"]


def load_npz_state_dict(path) -> Dict[str, torch.Tensor]:
    """State dict of `Generator` from an exported ``.npz``."""
    return flax_to_state_dict(*load_npz_trees(path))
