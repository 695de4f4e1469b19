"""The process group of a multi-process (multi-GPU) run.

Counterpart of healthivert_tpu/parallel/distributed.py:21-72 over
`torch.distributed`: one process per card, started by `torchrun`, which sets
RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and MASTER_PORT. The collectives
are kept to `all_reduce`, `broadcast` and `barrier`, which NCCL and gloo both
take for CUDA tensors.

With no process group every helper here is the identity: no collective and
no synchronisation, so a one-process run is unchanged.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

# how long init_process_group and every later collective wait for the other
# ranks before they raise
TIMEOUT = datetime.timedelta(minutes=10)


def is_multiprocess() -> bool:
    return dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1


def process_count() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def ensure_initialized(device=None, backend=None, init_method="env://",
                       timeout: datetime.timedelta = TIMEOUT) -> int:
    """Join the process group that torchrun's environment describes, once;
    returns the process count (1 without torchrun).

    The backend follows the device: NCCL for a card, gloo for the CPU; a
    caller may name it. A CUDA `device` becomes the process's current card.
    The group then runs one all_reduce at once, so that a rank that cannot
    reach the others fails here, within `timeout`, and not in its first
    training step. A backend that fails to start raises."""
    if dist.is_initialized():
        return process_count()
    if "WORLD_SIZE" not in os.environ:
        return 1
    dev = torch.device(device) if device is not None else torch.device("cpu")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    kwargs = dict(device_id=dev) if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=init_method, timeout=timeout,
                            rank=int(os.environ["RANK"]),
                            world_size=int(os.environ["WORLD_SIZE"]), **kwargs)
    handshake = torch.ones(1, device=dev)
    dist.all_reduce(handshake)
    if int(handshake.item()) != process_count():
        raise RuntimeError(f"process group handshake summed {handshake.item()}, "
                           f"expected {process_count()}")
    print(f"process group: backend {dist.get_backend()}, rank {process_index()} of "
          f"{process_count()}, device {dev}", flush=True)
    return process_count()


# (this rank's coordinate on the data axis, the data axis's size): part of
# the process group's layout, so set with it (by parallel/mesh.make_mesh)
# and cleared by shutdown; None: the data axis is the world
_DATA_AXIS = None


def shutdown() -> None:
    """Leave the process group, if there is one."""
    global _DATA_AXIS
    _DATA_AXIS = None
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def set_data_axis(index: int, size: int) -> None:
    """Record this rank's place on the data axis (parallel/mesh.make_mesh
    does, under a process group); the ranks that share a data coordinate
    are replicas of one shard, one per model coordinate."""
    global _DATA_AXIS
    _DATA_AXIS = (index, size)


def data_axis() -> tuple:
    """(this rank's data coordinate, the data axis's size)."""
    return _DATA_AXIS if _DATA_AXIS is not None else (process_index(), process_count())


def replicas() -> int:
    """Ranks that hold each data shard: the size of the model axis."""
    return process_count() // data_axis()[1]


def process_batch_slice(global_batch: int) -> slice:
    """This process's contiguous slice of a globally indexed batch: the
    slice of its data coordinate."""
    index, size = data_axis()
    per = global_batch // size
    start = per * index
    return slice(start, start + per)


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum of `t` over the ranks, differentiable: the backward sums the
    cotangents over the ranks too."""
    if not is_multiprocess():
        return t
    from torch.distributed.nn.functional import all_reduce

    return all_reduce(t)


@torch.no_grad()
def all_reduce_mean(t: torch.Tensor) -> torch.Tensor:
    """The mean of `t` over the ranks, without a gradient (a new tensor)."""
    if not is_multiprocess():
        return t
    out = t.detach().clone()
    dist.all_reduce(out)
    return out / process_count()


@torch.no_grad()
def average_gradients(module: torch.nn.Module) -> None:
    """Replace every parameter's .grad by its mean over the ranks, in one
    all_reduce of the gradients flattened together. Under a model axis the
    ranks of one data shard hold equal gradients; each shard then enters
    the mean replicas() times, as every other shard does, so the mean over
    the ranks is the mean over the data shards."""
    if not is_multiprocess():
        return
    grads = [p.grad for p in module.parameters() if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat)
    flat /= process_count()
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


@torch.no_grad()
def broadcast_module(module: torch.nn.Module, src: int = 0) -> None:
    """Overwrite every parameter and buffer of `module` with rank `src`'s."""
    if not is_multiprocess():
        return
    for t in module.state_dict().values():
        dist.broadcast(t, src)


@torch.no_grad()
def checksum(modules) -> torch.Tensor:
    """An order-independent integer digest of the modules' parameters and
    buffers: per tensor the sum of its elements' bit patterns, weighted by
    the tensor's position (int64 on the modules' device)."""
    total = None
    k = 0
    for m in modules:
        for t in m.state_dict().values():
            k += 1
            bits = t.detach().contiguous().view(torch.int32) if t.dtype == torch.float32 \
                else t.detach().to(torch.int64)
            s = bits.to(torch.int64).sum() * k
            total = s if total is None else total + s
    return total.reshape(1)


@torch.no_grad()
def check_replicated(modules, what: str = "replicas") -> None:
    """Raise when the ranks' copies of `modules` differ in any bit that the
    checksum sees: two all_reduces (max and min) of one integer."""
    if not is_multiprocess():
        return
    c = checksum(modules)
    hi, lo = c.clone(), c.clone()
    dist.all_reduce(hi, op=dist.ReduceOp.MAX)
    dist.all_reduce(lo, op=dist.ReduceOp.MIN)
    if int(hi.item()) != int(lo.item()):
        raise RuntimeError(f"{what} differ across the {process_count()} ranks "
                           f"(checksums {int(lo.item())} .. {int(hi.item())})")


def barrier() -> None:
    if is_multiprocess():
        dist.barrier()
