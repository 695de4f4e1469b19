"""Host->device prefetching: overlap NIfTI IO + slice geometry with compute.

A copy of healthivert_tpu/data/prefetch.py:17-42: a background thread runs
the batch iterator and the placement ahead of the consumer (double
buffering), so the training step does not wait on the host. On CUDA,
`to_device` copies each array from pinned host memory without blocking the
host.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterable, Iterator

import numpy as np
import torch

_SENTINEL = object()


def prefetch_to_device(iterable: Iterable, place_fn, depth: int = 2) -> Iterator:
    """Yields place_fn(batch) for each batch, produced ahead by a worker.
    Exceptions in the worker propagate to the consumer. When the consumer
    stops early (a break, --max_steps), the worker stops too instead of
    blocking on the full queue for the rest of the process."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()

    def put(item):
        while not stop.is_set():
            try:
                q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for batch in iterable:
                if not put(place_fn(batch)):
                    return
        except BaseException as e:  # propagate into the consuming thread
            put(("__error__", e))
        finally:
            put(_SENTINEL)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is _SENTINEL:
                break
            if isinstance(item, tuple) and len(item) == 2 and item[0] == "__error__":
                raise item[1]
            yield item
    finally:
        stop.set()
        t.join()


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """A host batch as tensors on `device`: on CUDA through pinned memory
    with non_blocking copies, on the CPU as views of the arrays."""
    device = torch.device(device)
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out[k] = t
    return out
