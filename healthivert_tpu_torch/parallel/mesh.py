"""The device mesh of data-parallel runs, and batches split over it.

Counterpart of healthivert_tpu/parallel/mesh.py:21-94. The networks are
small, so parallelism is data parallelism: the batch is split over the
`data` axis and every shard runs a full replica. A `model` axis means what
it means in the JAX package, whose graph does not use it (mesh.py:7-8): the
parameters are replicated over it and the batch is sharded over `data`
only, so the devices of one model group would compute the same numbers.
The devices are laid out in the spec's axis order, as the JAX package's
np.array(devices[:total]).reshape(sizes) lays them out.

Two kinds of mesh:
- in one process, `devices` holds the mesh's devices in that layout, and
  each data shard runs once, on the first device of its model group
  (`data_devices`). A device may repeat, so one card (or the CPU) can hold
  a data axis of 2;
- under a process group of several processes (torchrun), the mesh spans
  the ranks, one device a rank, in the same layout; `devices` holds this
  rank's device, and each rank feeds the shard of its data coordinate
  (distributed.process_batch_slice).
"""

from __future__ import annotations

import copy
import dataclasses
import math
from typing import Dict, List, Tuple

import numpy as np
import torch

from . import distributed


@dataclasses.dataclass(frozen=True)
class Mesh:
    shape: Dict[str, int]
    devices: Tuple[torch.device, ...]
    processes: int = 1  # processes the data axis spans

    @property
    def size(self) -> int:
        """Shards of the data axis."""
        return self.shape.get("data", 1)

    @property
    def data_stride(self) -> int:
        """Mesh positions between two data coordinates in the layout."""
        axes = list(self.shape)
        if "data" not in axes:
            return 1
        return math.prod(list(self.shape.values())[axes.index("data") + 1:])

    @property
    def data_devices(self) -> Tuple[torch.device, ...]:
        """The device of each data shard: the first of its model group (in
        one process), or this rank's device (under a process group)."""
        if self.processes > 1:
            return self.devices
        return tuple(self.devices[d * self.data_stride] for d in range(self.size))


def mesh_shape(spec: str, n_devices: int) -> Dict[str, int]:
    """The axis sizes of 'axis:n[,axis:n]' over n_devices, as the JAX
    package's make_mesh computes them: n = -1 (or no n) takes the devices
    that the other axes leave."""
    axes, sizes = [], []
    for part in spec.split(","):
        name, _, n = part.partition(":")
        axes.append(name.strip())
        sizes.append(int(n) if n else -1)
    known = math.prod(s for s in sizes if s > 0)
    return dict(zip(axes, (s if s > 0 else n_devices // known for s in sizes)))


def _local_device() -> torch.device:
    return torch.device("cuda", torch.cuda.current_device()) if torch.cuda.is_available() \
        else torch.device("cpu")


def _device(d) -> torch.device:
    """`d` as a torch.device with its card's index ("cuda" is the current
    card), so that equal devices compare equal."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


def make_mesh(spec: str = "data:-1", devices=None) -> Mesh:
    """The mesh of `spec`. Default devices: in one process the visible
    cards; under a process group of several processes the mesh spans the
    ranks, and `devices` may name this rank's device (default: its current
    card, else the CPU). Under a process group it records this rank's data
    coordinate (distributed.set_data_axis)."""
    world = distributed.process_count()
    if world > 1:
        local = [_device(d) for d in devices] if devices is not None else [_local_device()]
        if len(local) != 1:
            raise ValueError(f"under a process group a rank feeds one device, got {local}")
        shape = mesh_shape(spec, world)
    else:
        if devices is None:
            if not torch.cuda.is_available():
                raise RuntimeError("make_mesh: no card is visible; name the devices "
                                   "(devices=['cpu', ...])")
            devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
        local = [_device(d) for d in devices]
        shape = mesh_shape(spec, len(local))
    total = math.prod(shape.values())
    if world > 1:
        if total != world:
            raise ValueError(
                f"--mesh {spec} asks for {total} devices, but {world} processes run; "
                f"start one process per device: torchrun --nproc_per_node {total} ...")
        mesh = Mesh(shape, tuple(local), processes=world)
        distributed.set_data_axis(
            distributed.process_index() // mesh.data_stride % mesh.size, mesh.size)
        return mesh
    if total > len(local) or total < 1:
        raise ValueError(
            f"--mesh {spec} needs {total} devices, {len(local)} given (training runs one "
            f"process per shard: torchrun --nproc_per_node {total} ...)")
    return Mesh(shape, tuple(local[:total]))


def pad_batch(batch: dict, size: int) -> dict:
    """Pad a batch dict's leading dim up to `size` by cyclic repetition
    (healthivert_tpu/parallel/mesh.py:45-57): a trailing short batch keeps
    the step's shape and divides the mesh; training then weights the
    repeated examples double, evaluation drops them from its sums."""
    n = next(iter(batch.values())).shape[0]
    if n == size:
        return batch
    reps = -(-size // n)
    return {k: np.concatenate([np.asarray(v)] * reps)[:size] for k, v in batch.items()}


def split_batch(batch: dict, parts: int) -> List[dict]:
    """A host batch dict as `parts` equal chunks along the leading dim."""
    n = next(iter(batch.values())).shape[0]
    if n % parts:
        raise ValueError(f"a batch of {n} does not split into {parts} equal shards")
    per = n // parts
    return [{k: v[i * per:(i + 1) * per] for k, v in batch.items()} for i in range(parts)]


def shard_batch(batch: dict, mesh: Mesh) -> List[dict]:
    """A host batch on the mesh, one dict of tensors per shard this process
    feeds: in one process the whole batch split over `mesh.devices`; under a
    process group `batch` is the global batch and this rank keeps its slice
    (distributed.process_batch_slice)."""
    from ..data.prefetch import to_device

    if mesh.processes > 1:
        n = next(iter(batch.values())).shape[0]
        part = distributed.process_batch_slice(n)
        return [to_device({k: v[part] for k, v in batch.items()}, mesh.devices[0])]
    return [to_device(b, d) for b, d in zip(split_batch(batch, mesh.size), mesh.data_devices)]


def replicate_state(module: torch.nn.Module, mesh: Mesh) -> List[torch.nn.Module]:
    """One replica of `module` per data shard of the mesh. In one process a
    replica per distinct device of `data_devices` (shards on one device
    share it; `module` itself serves its own device); under a process group
    rank 0's module, broadcast to every rank and checked by checksum."""
    if mesh.processes > 1:
        distributed.broadcast_module(module)
        distributed.check_replicated([module], "replicated modules")
        return [module]
    home = next(module.parameters()).device
    replicas = {}
    for d in mesh.data_devices:
        if d not in replicas:
            replicas[d] = module if d == home else copy.deepcopy(module).to(d)
    return [replicas[d] for d in mesh.data_devices]
