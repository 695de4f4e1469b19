"""The port's 3D synthesis and test CLIs against the root CLIs of the JAX
package, end to end on the CPU (--gpu_ids -1, float32, --crop_size 64) on
the cohort of tests/cli_cohort.py, with the shipped generator: the port
reads it through --load_npz, the JAX CLIs from the orbax checkpoint.

The train CLI is held in tests/test_torch_cli_train.py.

3D synthesis. The synthesis turns float outputs into discrete ones (the
predicted height through ceil, the seg through > 0.5, the CT through uint8
rounding), and each pass feeds the next, so float32 differences of ~1e-7
can flip one where a value sits on the edge: CT_fake within 1 grey level,
label_fake equal on >= 99.9 % of voxels (as tests/test_torch_infer3d.py);
affines equal. --spine_batch 0 and 1 give equal outputs in the port.

Test gallery. Equal file names; fake_B within 1 grey level; the masks equal
on >= 99.9 % of pixels; offset_flow equal on >= 99 % of pixels: the flow
colours each 8 x 8 block by the attention's argmax over the candidate
patches, and where two candidates' scores tie to within float32 rounding
the two packages may pick different ones, which recolours that block.

Without --gpu_ids -1 and with no card, each CLI raises.
"""

import os

import numpy as np
import pytest
import torch
from PIL import Image

import eval_3d_sagittal_twostage as jax_e3
import test as jax_test
from cli_cohort import NPZ, skip_jax_init, shipped_run_dir, write_cohort
from healthivert_tpu_torch.cli import eval_3d_sagittal_twostage as e3
from healthivert_tpu_torch.cli import test as test_cli
from healthivert_tpu_torch.cli import train as train_cli
from healthivert_tpu_torch.engine.visualizer import read_png
from healthivert_tpu_torch.utils import nifti
from torch_port_fixtures import one_torch_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

COMMON = ["--gpu_ids", "-1", "--crop_size", "64", "--compute_dtype", "float32"]


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    return write_cohort(str(tmp_path_factory.mktemp("cohort")))


def _e3_port(cohort, tmp, out, spine_batch="1"):
    return e3.main(["--dataroot", cohort, "--name", "e3", "--checkpoints_dir", str(tmp / "ck"),
                    "--results_dir", str(out), "--slice_batch", "8", "--load_npz", NPZ,
                    "--spine_batch", spine_batch, *COMMON])


def test_eval_3d_matches_the_root_cli(cohort, tmp_path, monkeypatch):
    skip_jax_init(monkeypatch, jax_e3)
    jax_e3.main(["--dataroot", cohort, "--name", "pretrained_synthetic",
                 "--checkpoints_dir", shipped_run_dir(str(tmp_path)),
                 "--results_dir", str(tmp_path / "jax"), "--slice_batch", "8",
                 "--mesh", "data:1", *COMMON])
    stats = _e3_port(cohort, tmp_path, tmp_path / "port")
    assert len(stats["patients"]) == 4 and stats["total_s"] > 0
    files = sorted(os.listdir(os.path.join(cohort, "CT")))
    assert len(files) == 8
    for sub in ("CT_fake", "label_fake"):
        assert sorted(os.listdir(tmp_path / "port" / sub)) == files
    for f in files:
        src = nifti.load(os.path.join(cohort, "CT", f))
        for sub in ("CT_fake", "label_fake"):
            got = nifti.load(tmp_path / "port" / sub / f)
            want = nifti.load(tmp_path / "jax" / sub / f)
            assert got.data.shape == src.data.shape and got.data.dtype == np.float32
            np.testing.assert_array_equal(got.affine, src.affine)
            np.testing.assert_array_equal(got.affine, want.affine)
            if sub == "CT_fake":
                assert np.abs(got.data - want.data).max() <= 1.0, f
            else:
                assert np.mean(got.data == want.data) >= 0.999, f
        assert (nifti.load(tmp_path / "port" / "label_fake" / f).data > 0).any()

    # one vertebra per pass set gives the same volumes; existing outputs
    # are skipped
    _e3_port(cohort, tmp_path, tmp_path / "serial", spine_batch="0")
    for sub in ("CT_fake", "label_fake"):
        for f in files:
            np.testing.assert_array_equal(nifti.load(tmp_path / "serial" / sub / f).data,
                                          nifti.load(tmp_path / "port" / sub / f).data)
    assert _e3_port(cohort, tmp_path, tmp_path / "port")["patients"] == []


def _png(path):
    return np.asarray(Image.open(path)).astype(int)


def test_test_gallery_matches_the_root_cli(cohort, tmp_path, monkeypatch):
    skip_jax_init(monkeypatch, jax_test)
    jax_test.main(["--dataroot", cohort, "--name", "pretrained_synthetic",
                   "--checkpoints_dir", shipped_run_dir(str(tmp_path)),
                   "--results_dir", str(tmp_path / "jax"), "--num_test", "2", *COMMON])
    test_cli.main(["--dataroot", cohort, "--name", "pretrained_synthetic",
                   "--checkpoints_dir", str(tmp_path / "ck"), "--load_npz", NPZ,
                   "--results_dir", str(tmp_path / "port"), "--num_test", "2", *COMMON])
    web = os.path.join("pretrained_synthetic", "test_latest")
    jdir, pdir = tmp_path / "jax" / web, tmp_path / "port" / web
    assert (pdir / "index.html").read_text() == (jdir / "index.html").read_text()
    names = sorted(os.listdir(jdir / "images"))
    assert sorted(os.listdir(pdir / "images")) == names and len(names) == 14
    for n in names:
        g, w = _png(pdir / "images" / n), _png(jdir / "images" / n)
        assert g.shape == w.shape, n
        if "mask" in n or "seg" in n:
            assert np.mean(g == w) >= 0.999, n
        elif "offset_flow" in n:
            assert g.shape == (64, 64, 3)
            assert np.mean((g == w).all(-1)) >= 0.99, n
        else:
            assert np.abs(g - w).max() <= 1, n
        np.testing.assert_array_equal(read_png(pdir / "images" / n), g)


@pytest.mark.parametrize("cli", [e3, test_cli, train_cli], ids=["eval_3d", "test", "train"])
def test_without_a_card_each_cli_raises(cohort, tmp_path, cli):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a card")
    extra = [] if cli is train_cli else ["--results_dir", str(tmp_path / "r")]
    with pytest.raises(RuntimeError, match="--gpu_ids -1"):
        cli.main(["--dataroot", cohort, "--checkpoints_dir", str(tmp_path), "--load_npz", NPZ,
                  *extra])


@pytest.mark.parametrize("cli", ["eval_3d_sagittal_twostage", "train", "test"])
def test_help_lists_the_root_flags(cli, capsys):
    import importlib

    root = importlib.import_module(cli)
    port = importlib.import_module(f"healthivert_tpu_torch.cli.{cli}")
    flags = []
    for mod in (root, port):
        with pytest.raises(SystemExit):
            mod.main(["--help"])
        out = capsys.readouterr().out
        flags.append({w.split("=")[0].strip("[],") for w in out.split() if w.startswith("--")})
    missing = flags[0] - flags[1]
    assert not missing, missing
    assert "--load_npz" in flags[1]
