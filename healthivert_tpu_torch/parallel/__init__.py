"""Data parallelism over several cards: the device mesh and the process
group (healthivert_tpu/parallel)."""

from .distributed import ensure_initialized, process_batch_slice  # noqa: F401
from .mesh import Mesh, make_mesh, pad_batch, replicate_state, shard_batch  # noqa: F401
