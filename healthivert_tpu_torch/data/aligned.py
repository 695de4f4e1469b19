"""AlignedDataset: the real straightened-vertebra training set.

A copy of healthivert_tpu/data/aligned.py:27-238 (parity with the
reference's data/aligned_dataset.py): reads the split json
(vertebra_data_local.json / vertebra_data.json), partitions vertebrae into
normal (grade <= 1) vs abnormal (:57-82), loads per-vertebra CT/label (and
optional HGAM CAM) NIfTIs from {dataroot}/{CT,label}/{patient}_{vert}.nii.gz,
and builds batches with the shared host sampler. IO + geometry run in a
thread pool ('--num_threads').

Under a torch.distributed group of several processes a training dataset
loads only this process's slice of each global batch
(parallel/distributed.process_batch_slice), as the JAX package does per
JAX process; evaluation datasets are read whole by every process.
"""

from __future__ import annotations

import json
import os
import threading
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional

import numpy as np

from ..parallel import distributed
from ..utils import nifti
from .sampler import build_example, collate


def load_split(path: str, phase: str):
    """Returns {patient_vert_id: grade} for a phase (train/test/val)."""
    with open(path) as f:
        data = json.load(f)
    return data[phase]


def partition_normal(split: Dict[str, int]):
    """grade <= 1 is 'normal' (aligned_dataset.py:62)."""
    normal, abnormal = [], []
    normal_by_patient: Dict[str, List[str]] = {}
    for pv, grade in split.items():
        patient, vert = pv.rsplit("_", 1)
        if int(grade) <= 1:
            normal.append(pv)
            normal_by_patient.setdefault(patient, []).append(vert)
        else:
            abnormal.append(pv)
    return normal, abnormal, normal_by_patient


def find_cam_path(cam_dir: str, pv: str) -> Optional[str]:
    """CAM heatmap lookup order: _0, _1, bare (aligned_dataset.py:164-170)."""
    for suffix in ("_0", "_1", ""):
        p = os.path.join(cam_dir, f"{pv}{suffix}.nii.gz")
        if os.path.exists(p):
            return p
    return None


class AlignedDataset:
    def __init__(self, opt):
        self.opt = opt
        self.batch_size = opt.batch_size
        self.rng = np.random.default_rng(opt.seed)
        self.dataroot = opt.dataroot
        self.cam_dir = getattr(opt, "cam_dir", None)

        # Search order: dataroot, cwd, then the shipped repo-root copy of the
        # Verse2019 splits (vertebra_data.json, 1460 vertebrae — the file the
        # reference consumes at data/aligned_dataset.py:49).
        repo_root = os.path.dirname(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        )
        split_path = None
        for cand in ("vertebra_data_local.json", "vertebra_data.json"):
            for base in (self.dataroot or ".", ".", repo_root):
                p = os.path.join(base, cand)
                if os.path.exists(p):
                    split_path = p
                    break
            if split_path:
                break
        if split_path is None:
            raise FileNotFoundError(
                "no vertebra_data_local.json / vertebra_data.json found "
                f"in {self.dataroot!r} or cwd"
            )
        split = load_split(split_path, opt.phase)
        normal, abnormal, self.normal_by_patient = partition_normal(split)
        vert_class = getattr(opt, "vert_class", "normal")
        self.vertebra_ids = normal if vert_class == "normal" else abnormal
        # keep only vertebrae whose volumes exist on disk
        self.vertebra_ids = [
            pv for pv in self.vertebra_ids
            if os.path.exists(os.path.join(self.dataroot, "CT", pv + ".nii.gz"))
        ]
        if not self.vertebra_ids:
            raise FileNotFoundError(
                f"no CT volumes under {self.dataroot}/CT for split {opt.phase}"
            )
        # --num_threads is honored as given (reference parity): for warm,
        # CPU-bound loading, threads beyond cores only add GIL contention,
        # but cold or network-filesystem reads are latency-bound and
        # legitimately oversubscribe, so no silent clamp
        self.pool = ThreadPoolExecutor(max_workers=max(1, opt.num_threads))
        self.serial = getattr(opt, "serial_batches", False)
        self._epoch = -1
        # LRU cache of decompressed volumes. Each 1-slice example otherwise
        # gunzips 2-3 full 256x256x64 NIfTIs. Stored compactly (CT/CAM uint8, labels
        # uint8): quantization commutes with build_example's row
        # selections, so cached batches are bit-identical
        # (tests/test_torch_aligned.py). --data_cache_gb 0 disables.
        self._cache_cap = int(float(getattr(opt, "data_cache_gb", 4.0) or 0.0) * 1e9)
        self._cache: "OrderedDict[str, tuple]" = OrderedDict()
        self._cache_bytes = 0
        self._cache_lock = threading.Lock()
        # data parallelism over processes: every process derives the same
        # epoch order (shared seed) but loads only its own contiguous slice
        # of each global batch. Training datasets only: evaluation splits
        # are read whole by every process, which keeps the plateau policy's
        # metric the same everywhere
        self.local_slice = None
        shards = distributed.data_axis()[1]
        if distributed.process_count() > 1 and getattr(opt, "isTrain", False):
            if self.batch_size % shards != 0:
                raise ValueError(
                    f"batch_size {self.batch_size} must divide by the {shards} "
                    "data shards"
                )
            self.local_slice = distributed.process_batch_slice(self.batch_size)

    def __len__(self):
        return len(self.vertebra_ids)

    def _load_volumes(self, pv: str):
        """Decompressed (ct, labels, cam) for a vertebra, LRU-cached.

        CT/CAM are cached uint8 and labels uint8: build_example only ever
        row-selects these values before its own uint8 quantization
        (sampler.py to_unit), so pre-quantizing is exact. A miss does IO
        outside the lock; concurrent misses on the same pv (trailing-batch
        repetition) load twice harmlessly."""
        if self._cache_cap:
            with self._cache_lock:
                hit = self._cache.get(pv)
                if hit is not None:
                    self._cache.move_to_end(pv)
                    return hit
        ct = nifti.load(os.path.join(self.dataroot, "CT", pv + ".nii.gz")).get_fdata()
        labels = nifti.load(
            os.path.join(self.dataroot, "label", pv + ".nii.gz")
        ).get_fdata()
        cam = None
        if self.cam_dir:
            cp = find_cam_path(self.cam_dir, pv)
            if cp:
                cam = nifti.load(cp).get_fdata()
        if not self._cache_cap:
            return ct, labels, cam
        # labels feed equality tests (labels == vert_id): narrow only when
        # every value is an INTEGER in uint8 range — truncating a
        # float-valued label map (e.g. scl_slope rescaling) would silently
        # change vertebra membership vs the uncached compare
        if (
            labels.size
            and 0 <= labels.min()
            and labels.max() <= 255
            and np.array_equal(labels, np.round(labels))
        ):
            lab = labels.astype(np.uint8)
        else:
            lab = labels  # keep the exact values (rare; costs f64 memory)
        entry = (
            ct.astype(np.uint8),
            lab,
            (cam * 255).astype(np.uint8) if cam is not None else None,
        )
        nbytes = sum(a.nbytes for a in entry if a is not None)
        with self._cache_lock:
            if pv not in self._cache:
                self._cache[pv] = entry
                self._cache_bytes += nbytes
                while self._cache_bytes > self._cache_cap and self._cache:
                    _, old = self._cache.popitem(last=False)
                    self._cache_bytes -= sum(a.nbytes for a in old if a is not None)
        return entry

    def _load_example(self, pv: str, global_idx: int = 0):
        patient, vert = pv.rsplit("_", 1)
        vert_id = int(vert)
        ct, labels, cam = self._load_volumes(pv)
        # the cache stores cam as uint8 pre-scaled by 255; the encoding is
        # this class's, so the flag is decided here, not by a dtype sniff
        # inside the shared sampler
        cam_scaled = cam is not None and cam.dtype == np.uint8
        normal_ids = [int(v) for v in self.normal_by_patient.get(patient, [])]
        # slice-sampling rng keyed by (seed, epoch, global example index):
        # deterministic regardless of thread scheduling
        rng = np.random.default_rng((self.opt.seed, self._epoch, global_idx))
        return build_example(
            rng, ct, labels, vert_id, normal_ids, cam, cam_scaled=cam_scaled
        )

    def __iter__(self):
        self._epoch += 1
        order = np.arange(len(self.vertebra_ids))
        if not self.serial:
            self.rng.shuffle(order)
        ids = [self.vertebra_ids[i] for i in order]
        # the final partial batch is yielded short, matching the reference
        # DataLoader's drop_last=False (reference data/__init__.py:88-93)
        # — every vertebra is seen each epoch/eval pass; the training loop
        # pads it back to the batch size (engine/train_loop.pad_batch)
        for i in range(0, len(ids), self.batch_size):
            chunk = ids[i : i + self.batch_size]
            gidx = list(range(i, i + len(chunk)))
            if self.local_slice is not None:
                if len(chunk) < self.batch_size:
                    # the slices need the full global size: pad the trailing
                    # chunk by repetition before slicing
                    reps = -(-self.batch_size // len(chunk))
                    chunk = (chunk * reps)[: self.batch_size]
                    gidx = (gidx * reps)[: self.batch_size]
                chunk = chunk[self.local_slice]
                gidx = gidx[self.local_slice]
            examples = list(self.pool.map(self._load_example, chunk, gidx))
            yield collate(examples)
