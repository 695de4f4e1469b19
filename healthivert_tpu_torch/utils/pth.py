"""Reading the reference's PyTorch ``.pth`` checkpoints into the port.

Counterpart of healthivert_tpu/utils/pth.py. The JAX package parses the
pickle by hand (it has no torch); here `torch.load(weights_only=True)`
reads it. The reference's key names go through copies of the JAX package's
`map_generator_state` (:234) and `map_discriminator_state` (:276), which
give the flax trees, and then through utils/weights.py's flax-to-state-dict
conversion. Every loaded tensor must name a tensor of the model, with its
shape (`_merge_validated`, :340): an unknown key raises KeyError, a shape
mismatch ValueError. Tensors the file lacks keep their current values.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn as nn

from .weights import flax_discriminator_to_state_dict, flax_to_state_dict


def _to_numpy_dict(obj, prefix="") -> Dict[str, np.ndarray]:
    """Flatten {state_dict or nested dict} into {dotted key: numpy array}."""
    out: Dict[str, np.ndarray] = {}
    if isinstance(obj, dict):
        for k, v in obj.items():
            if not isinstance(k, str):
                continue
            key = f"{prefix}{k}"
            if isinstance(v, dict):
                out.update(_to_numpy_dict(v, prefix=f"{key}."))
            elif isinstance(v, torch.Tensor):
                out[key] = v.detach().float().numpy() if v.is_floating_point() else v.numpy()
        return out
    if isinstance(obj, torch.Tensor):
        return {prefix.rstrip("."): obj.numpy()}
    raise ValueError(f"unsupported checkpoint root object {type(obj)}")


def read_pth(path: str) -> Dict[str, np.ndarray]:
    """A torch .pth checkpoint as {dotted key: numpy array}."""
    return _to_numpy_dict(torch.load(path, map_location="cpu", weights_only=True))


def map_generator_state(state: Dict[str, np.ndarray]) -> Tuple[dict, dict]:
    """Map reference-Generator torch keys to (params, sn) nested trees in the
    flax layout (a copy of the JAX package's): ``weight_orig`` OIHW conv
    weights -> HWIO kernels, (out, in) Linear weights -> (in, out), the
    spectral-norm ``weight_u`` -> sn ``u``; ``weight_v`` is dropped (the
    first power iteration rebuilds it)."""
    params: dict = {}
    sn: dict = {}

    def put(tree, dotted_path, leaf_name, value):
        node = tree
        for part in dotted_path:
            node = node.setdefault(part, {})
        node[leaf_name] = value

    for key, arr in state.items():
        parts = key.split(".")
        if parts[-1] in ("weight_v", "num_batches_tracked"):
            continue
        if parts[-1] == "weight_u":
            put(sn, parts[:-1], "u", np.asarray(arr, np.float32))
            continue
        if parts[-1] in ("weight_orig", "weight"):
            a = np.asarray(arr, np.float32)
            if a.ndim == 4:  # conv OIHW -> HWIO
                put(params, parts[:-1], "kernel", np.transpose(a, (2, 3, 1, 0)))
            elif a.ndim == 2:  # linear (out,in) -> (in,out)
                put(params, parts[:-1], "kernel", np.transpose(a, (1, 0)))
            else:
                put(params, parts[:-1], "kernel", a)
            continue
        if parts[-1] == "bias":
            put(params, parts[:-1], "bias", np.asarray(arr, np.float32))
    return params, sn


def map_discriminator_state(state: Dict[str, np.ndarray], n_layers: int = 3) -> Tuple[dict, dict]:
    """Map a reference NLayerDiscriminator state dict (an nn.Sequential
    ``model``: conv0 at model.0, then a (conv, norm, LeakyReLU) triple per
    layer from model.2, the output conv at model.{2 + 3 n_layers}) to the
    flax (params, batch_stats) trees, as the JAX package's copy does."""
    idx_to_name = {0: "conv0", 2 + n_layers * 3: "conv_out"}
    idx_to_norm = {}
    for n in range(1, n_layers + 1):
        base = 2 + (n - 1) * 3
        idx_to_name[base] = f"conv{n}"
        idx_to_norm[base + 1] = f"norm{n}"

    params: dict = {}
    stats: dict = {}
    for key, arr in state.items():
        parts = key.split(".")
        # PixelDiscriminator names its (layout-compatible) sequential 'net'
        if parts[0] not in ("model", "net") or len(parts) != 3:
            continue
        idx, leaf = int(parts[1]), parts[2]
        a = np.asarray(arr, np.float32)
        if idx in idx_to_name:
            name = idx_to_name[idx]
            if leaf == "weight":  # conv OIHW -> HWIO
                params.setdefault(name, {})["kernel"] = np.transpose(a, (2, 3, 1, 0))
            elif leaf == "bias":
                params.setdefault(name, {})["bias"] = a
        elif idx in idx_to_norm:
            name = idx_to_norm[idx]
            if leaf == "weight":
                params.setdefault(name, {})["scale"] = a
            elif leaf == "bias":
                params.setdefault(name, {})["bias"] = a
            elif leaf == "running_mean":
                stats.setdefault(name, {})["mean"] = a
            elif leaf == "running_var":
                stats.setdefault(name, {})["var"] = a
        else:
            raise KeyError(f"unexpected discriminator key {key}")
    return params, stats


def _merge_validated(module: nn.Module, loaded: Dict[str, torch.Tensor]) -> int:
    """Overlay `loaded` onto the module's state dict; every loaded tensor
    must exist there with the same shape. Returns the count loaded."""
    sd = module.state_dict()
    for k, v in loaded.items():
        if k not in sd:
            raise KeyError(f"checkpoint key {k} not in model")
        if tuple(sd[k].shape) != tuple(v.shape):
            raise ValueError(f"shape mismatch at {k}: model {tuple(sd[k].shape)} "
                             f"vs pth {tuple(v.shape)}")
        sd[k] = v.to(dtype=sd[k].dtype)
    module.load_state_dict(sd)
    return len(loaded)


def load_generator_pth(path: str, gen: nn.Module) -> int:
    """Overlay a reference .pth generator checkpoint onto `gen`; returns the
    count of tensors loaded. A checkpoint nested under 'state_dict' is
    unwrapped."""
    state = read_pth(path)
    if any(k.startswith("state_dict.") for k in state):
        state = {k[len("state_dict."):]: v for k, v in state.items()
                 if k.startswith("state_dict.")}
    return _merge_validated(gen, flax_to_state_dict(*map_generator_state(state)))


def load_discriminator_pth(path: str, disc: nn.Module, n_layers: int = 3) -> int:
    """Overlay a reference ``*_net_D_k.pth`` onto `disc`; returns the count
    of tensors loaded."""
    params, stats = map_discriminator_state(read_pth(path), n_layers=n_layers)
    return _merge_validated(disc, flax_discriminator_to_state_dict(params, stats))
