"""The port's straightening CLIs with --gpu_ids -1 against the root scripts
(straighten/location_json_local.py, straighten/straighten_mask_3d.py, which
run the JAX package) on the raw cohort of tests/straighten_cohort.py: the
same centroid json and printed lines; the same crops, label and mask_2d
files bit for bit and CT files within 1e-3 (the order-1 resample sums in
another order than XLA's), with the default mask mode and --reorient RAI,
with --split and each other --mask_mode. Without --gpu_ids -1 and without
a card, the port's CLIs raise."""

import importlib.util
import os
import shutil

import numpy as np
import pytest
import torch

from healthivert_tpu_torch.cli import location_json_local, straighten_mask_3d
from healthivert_tpu_torch.utils import nifti
from straighten_cohort import SIZE, write_raw_cohort

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CT_ATOL = 1e-3  # the 0-255 window's scale


def _root_script(name):
    spec = importlib.util.spec_from_file_location(
        f"root_{name}", os.path.join(ROOT, "straighten", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def raw(tmp_path_factory):
    """The raw cohort with the root script's centroid json beside each mask."""
    root = write_raw_cohort(str(tmp_path_factory.mktemp("straighten") / "raw"))
    _root_script("location_json_local").main(["--root", root])
    return root


def test_location_json_local_equals_root(raw, tmp_path, capsys):
    mine = str(tmp_path / "raw")
    shutil.copytree(raw, mine, ignore=shutil.ignore_patterns("*.json"))
    capsys.readouterr()
    written = location_json_local.main(["--root", mine, "--gpu_ids", "-1"])
    printed = capsys.readouterr().out
    _root_script("location_json_local").main(["--root", raw])
    assert printed == capsys.readouterr().out
    assert sorted(written) == ["p0", "p1", "p2"]
    assert [e["label"] for e in written["p1"]] == [18, 19, 20, 21]  # the cut top vertebra
    for p in written:
        with open(f"{mine}/{p}/{p}.json") as f, open(f"{raw}/{p}/{p}.json") as g:
            assert f.read() == g.read()


def _crops(out):
    return sorted(f[:-len(".nii.gz")] for f in os.listdir(os.path.join(out, "label")))


@pytest.mark.parametrize("flags", [["--reorient", "RAI"], ["--mask_mode", "left", "--split"],
                                   ["--mask_mode", "3d"]],
                         ids=["rect_reorient", "left_split", "3d"])
def test_straighten_mask_3d_equals_root(raw, tmp_path, capsys, flags):
    if "--split" in flags:
        flags = flags + [os.path.join(raw, "split.json")]
    common = ["--root", raw, "--size", *SIZE] + flags
    capsys.readouterr()
    done = straighten_mask_3d.main(common + ["--out", str(tmp_path / "port"), "--gpu_ids", "-1"])
    printed = capsys.readouterr().out
    _root_script("straighten_mask_3d").main(common + ["--out", str(tmp_path / "root")])
    assert printed == capsys.readouterr().out
    names = _crops(tmp_path / "root")
    assert sorted(done) == _crops(tmp_path / "port") == names
    assert len(names) == (5 if "--split" in flags else 14)
    size = tuple(int(s) for s in SIZE)
    for n in names:
        for kind in ("CT", "label", "mask_2d"):
            mine = nifti.load(tmp_path / "port" / kind / f"{n}.nii.gz")
            want = nifti.load(tmp_path / "root" / kind / f"{n}.nii.gz")
            assert mine.data.shape == want.data.shape == size
            np.testing.assert_array_equal(mine.affine, want.affine)
            if kind == "CT":
                np.testing.assert_allclose(mine.data, want.data, rtol=0, atol=CT_ATOL, err_msg=n)
            else:
                np.testing.assert_array_equal(mine.data, want.data, err_msg=f"{kind}/{n}")
        label = nifti.load(tmp_path / "port" / "label" / f"{n}.nii.gz").data
        assert (label == int(n.rsplit("_", 1)[1])).sum() > 1000  # the crop holds its vertebra


def test_cli_without_a_card_raises(raw, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--gpu_ids -1"):
        straighten_mask_3d.main(["--root", raw, "--out", str(tmp_path / "out")])
    with pytest.raises(RuntimeError, match="--gpu_ids -1"):
        location_json_local.main(["--root", raw])
    assert not (tmp_path / "out").exists()
