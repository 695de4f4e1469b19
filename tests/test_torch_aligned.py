"""Port vs JAX package: the straightened-vertebra dataset.

On one small cohort written with the JAX package's NIfTI writer (five
normal vertebrae, grade <= 1, over three patients, (64, 64, 16) volumes, one fractured
vertebra; CAM heatmaps named with the _0, _1 and bare suffixes, one
vertebra without), the port's AlignedDataset yields batches bit-equal to
the JAX one over two epochs: shuffled and serial, with the volume cache on
and off; the trailing batch is short (5 vertebrae, batch 2), as there. The
split file is found in the same order (dataroot, cwd, repository root), the
partition and CAM lookup agree, and the port's trailing-batch padding is
the JAX loop's.
"""

import json
import os
import types

import numpy as np
import pytest

from healthivert_tpu.data import aligned as jaligned
from healthivert_tpu.data.synthetic import make_spine_volume
from healthivert_tpu.parallel.mesh import pad_batch as jax_pad_batch
from healthivert_tpu.utils import nifti as jnifti
from healthivert_tpu_torch.data import aligned, create_dataset
from healthivert_tpu_torch.engine.train_loop import pad_batch

SPLIT = {"train": {"p0_19": 0, "p0_20": 1, "p1_19": 0, "p1_20": 3, "p2_19": 0, "p2_20": 0},
         "test": {"p3_20": 0}}
CAM_SUFFIX = {"p0_19": "_0", "p0_20": "_1", "p1_19": "", "p2_19": "_0"}  # p2_20: no CAM


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    root = tmp_path_factory.mktemp("cohort")
    rng = np.random.default_rng(0)
    for d in ("CT", "label", "CAM"):
        (root / d).mkdir()
    vols = {}
    for p in range(4):
        vols[p] = make_spine_volume(rng, shape=(64, 64, 16), vert_ids=(19, 20), vert_height=12,
                                    gap=5, fractured={20: 0.6} if p == 1 else None)
    for pv in [*SPLIT["train"], *SPLIT["test"]]:
        ct, labels, cam = vols[int(pv[1])]
        jnifti.save(jnifti.Nifti1Image(ct.astype(np.float32)), str(root / "CT" / f"{pv}.nii.gz"))
        jnifti.save(jnifti.Nifti1Image(labels.astype(np.int16)),
                    str(root / "label" / f"{pv}.nii.gz"))
        if pv in CAM_SUFFIX:
            heat = rng.random(cam.shape).astype(np.float32)
            jnifti.save(jnifti.Nifti1Image(heat),
                        str(root / "CAM" / f"{pv}{CAM_SUFFIX[pv]}.nii.gz"))
    (root / "vertebra_data_local.json").write_text(json.dumps(SPLIT))
    return root


def _opt(root, **kw):
    base = dict(batch_size=2, seed=4, dataroot=str(root), phase="train", vert_class="normal",
                num_threads=2, serial_batches=False, cam_dir=str(root / "CAM"),
                data_cache_gb=4.0, dataset_mode="aligned", isTrain=True)
    base.update(kw)
    return types.SimpleNamespace(**base)


def _epochs(ds, n=2):
    return [[{k: np.asarray(v) for k, v in b.items()} for b in ds] for _ in range(n)]


@pytest.mark.parametrize("serial", [False, True], ids=["shuffled", "serial"])
@pytest.mark.parametrize("cache_gb", [4.0, 0.0], ids=["cache", "no-cache"])
def test_batches_bit_equal_over_two_epochs(cohort, serial, cache_gb):
    opt = _opt(cohort, serial_batches=serial, data_cache_gb=cache_gb)
    got = _epochs(create_dataset(opt))
    want = _epochs(jaligned.AlignedDataset(opt))
    assert [len(e) for e in got] == [3, 3]
    assert [len(b["full"]) for b in got[0]] == [2, 2, 1]  # short trailing batch
    for eg, ew in zip(got, want):
        for bg, bw in zip(eg, ew):
            assert bg.keys() == bw.keys()
            for k in bw:
                assert bg[k].dtype == bw[k].dtype and np.array_equal(bg[k], bw[k]), k
    assert not all(np.array_equal(a["full"], b["full"]) for a, b in zip(*got))  # epochs differ


def test_vert_class_test_split_and_partition(cohort):
    for phase, vc in (("train", "abnormal"), ("test", "normal")):
        opt = _opt(cohort, phase=phase, vert_class=vc, serial_batches=True)
        assert create_dataset(opt).vertebra_ids == jaligned.AlignedDataset(opt).vertebra_ids
    assert aligned.partition_normal(SPLIT["train"]) == jaligned.partition_normal(SPLIT["train"])
    for pv in [*SPLIT["train"], "p9_1"]:
        assert aligned.find_cam_path(str(cohort / "CAM"), pv) == \
            jaligned.find_cam_path(str(cohort / "CAM"), pv)


def test_split_file_search_order(cohort, tmp_path, monkeypatch):
    """dataroot's vertebra_data_local.json, else the cwd's, else the
    repository root's vertebra_data.json; then no split raises."""
    data = tmp_path / "data"
    data.mkdir()
    for d in ("CT", "label"):
        os.symlink(cohort / d, data / d)
    monkeypatch.chdir(tmp_path)
    # no split in dataroot or cwd: the repository's Verse2019 split, where
    # none of this cohort's ids exist
    for mod in (aligned, jaligned):
        with pytest.raises(FileNotFoundError, match="no CT volumes"):
            mod.AlignedDataset(_opt(data))
    (tmp_path / "vertebra_data.json").write_text(json.dumps(SPLIT))
    ids = aligned.AlignedDataset(_opt(data)).vertebra_ids
    assert ids == jaligned.AlignedDataset(_opt(data)).vertebra_ids and len(ids) == 5
    (data / "vertebra_data_local.json").write_text(json.dumps({"train": {"p0_19": 0}}))
    for mod in (aligned, jaligned):
        assert mod.AlignedDataset(_opt(data)).vertebra_ids == ["p0_19"]


def test_trailing_batch_padding_is_the_jax_loops(cohort):
    short = next(b for b in create_dataset(_opt(cohort, serial_batches=True, batch_size=4))
                 if len(b["full"]) < 4)
    got, want = pad_batch(short, 4), jax_pad_batch(short, 4)
    for k in want:
        assert np.array_equal(got[k], want[k])
    assert np.array_equal(got["full"][1], short["full"][0])  # cyclic repetition
