"""The port's 3D synthesis and test CLIs at --compute_dtype int8 on the CPU
(--gpu_ids -1, --crop_size 64, the shipped generator through --load_npz),
on two patients of the cohort of tests/cli_cohort.py.

--int8_calib auto (the default) calibrates on the first batch and writes
the port's store {checkpoints_dir}/{name}/int8_quant.pt; a second run at
another --slice_batch reuses it and writes bit-equal volumes. The test
CLI writes its
gallery with static and with dynamic scales. The int8 path itself is held
against the JAX package in tests/test_torch_int8.py.
"""

import os

import numpy as np
import pytest

from cli_cohort import NPZ, write_cohort
from healthivert_tpu_torch.cli import eval_3d_sagittal_twostage as e3
from healthivert_tpu_torch.cli import test as test_cli
from healthivert_tpu_torch.cli import train as train_cli
from healthivert_tpu_torch.utils import nifti
from torch_port_fixtures import one_torch_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

INT8 = ["--gpu_ids", "-1", "--crop_size", "64", "--compute_dtype", "int8", "--load_npz", NPZ]


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    """Patients p1 (vertebra 20 fractured) and p3 (the test split) of the
    CLI cohort."""
    root = write_cohort(str(tmp_path_factory.mktemp("cohort")))
    for d in ("CT", "label"):
        for f in os.listdir(os.path.join(root, d)):
            if not f.startswith(("p1_", "p3_")):
                os.remove(os.path.join(root, d, f))
    return root


def _e3(cohort, tmp, out, *extra):
    return e3.main(["--dataroot", cohort, "--name", "e3", "--checkpoints_dir", str(tmp / "ck"),
                    "--results_dir", str(tmp / out), *INT8, *extra])


def test_eval_3d_int8_store_makes_runs_batch_independent(cohort, tmp_path):
    store = tmp_path / "ck" / "e3" / "int8_quant.pt"
    assert len(_e3(cohort, tmp_path, "a", "--slice_batch", "8")["patients"]) == 2
    assert store.is_file()
    stamp = store.stat().st_mtime_ns
    _e3(cohort, tmp_path, "b", "--slice_batch", "5")
    assert store.stat().st_mtime_ns == stamp  # read, not rewritten
    files = sorted(os.listdir(os.path.join(cohort, "CT")))
    assert len(files) == 4
    for f in files:
        for sub in ("CT_fake", "label_fake"):
            np.testing.assert_array_equal(nifti.load(tmp_path / "a" / sub / f).data,
                                          nifti.load(tmp_path / "b" / sub / f).data)
        assert (nifti.load(tmp_path / "a" / "label_fake" / f).data > 0).any()


def test_eval_3d_int8_dynamic_writes_no_store(cohort, tmp_path):
    stats = _e3(cohort, tmp_path, "dyn", "--slice_batch", "8", "--int8_calib", "dynamic")
    assert len(stats["patients"]) == 2
    assert not (tmp_path / "ck" / "e3" / "int8_quant.pt").exists()
    for f in os.listdir(os.path.join(cohort, "CT")):
        assert np.isfinite(nifti.load(tmp_path / "dyn" / "CT_fake" / f).data).all()


@pytest.mark.parametrize("calib", ["auto", "dynamic"])
def test_test_cli_int8_gallery(cohort, tmp_path, calib):
    cfg = test_cli.main(["--dataroot", cohort, "--name", "t8", "--checkpoints_dir",
                         str(tmp_path / "ck"), "--results_dir", str(tmp_path / "res"),
                         "--num_test", "2", "--int8_calib", calib, *INT8])
    assert cfg.compute_dtype == "int8"
    web = tmp_path / "res" / "t8" / "test_latest"
    assert (web / "index.html").is_file() and len(os.listdir(web / "images")) == 14


def test_train_cli_refuses_int8(cohort, tmp_path):
    with pytest.raises(SystemExit, match="inference-only"):
        train_cli.main(["--dataroot", cohort, "--checkpoints_dir", str(tmp_path), "--gpu_ids",
                        "-1", "--crop_size", "64", "--batch_size", "2", "--compute_dtype", "int8"])
