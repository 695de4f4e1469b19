"""The port's grading-chain CLIs against the root scripts of the JAX
package, on the CPU (--gpu_ids -1 where a CLI has it):

- the classifier CLI (python -m healthivert_tpu_torch.cli.grad_cam_3d_sagittal,
  root Attention/grad_CAM_3d_sagittal.py) on the cohort of
  tests/cli_cohort.py: `train` for 3 steps at batch 2 from the init the
  root script draws (its flax params carried across to the port's
  `train`), the same printed loss within 1e-4 and the same held-out vote
  accuracy, the trained weights within rtol 1e-4 (atol 1e-6) on >= 99 % of
  their entries, and the rest within the two packages' largest moves (lr a
  step each): Adam divides each gradient by its own magnitude, so where a
  gradient is near rounding level each package steps by up to lr in the
  direction of its own rounding; then `generate` from each
  package's own checkpoint: the same file names (the per-vertebra class
  suffixes) and CAMs within atol 1e-4;
- the evaluation CLIs on synthetic 128 x 128 x 32 volumes with an
  experiment dir of CT_fake/ and label_fake/: rhlv_quantification (and
  its coronal wrapper) writes tables equal byte for byte to the root
  script's, svm_grading and svm_grading_2_5d reports byte-equal, and
  generation_eval_sagittal (and its coronal wrapper, with the coronal
  dir-name filter) every average within rtol 1e-5 and the same count (the
  PSNR/SSIM float32 sums differ in their last bits between XLA and
  PyTorch, so their text is not byte-equal).
"""

import importlib.util
import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cli_cohort import write_cohort, write_eval_cohort
from healthivert_tpu.engine import checkpoint as jck
from healthivert_tpu.models.hgam import FractureClassifier as JaxClassifier
from healthivert_tpu_torch.cli import (
    generation_eval_coronal,
    generation_eval_sagittal,
    grad_cam_3d_sagittal,
    rhlv_quantification,
    rhlv_quantification_coronal,
    svm_grading,
    svm_grading_2_5d,
)
from healthivert_tpu_torch.models.hgam import FractureClassifier
from healthivert_tpu_torch.utils import nifti
from healthivert_tpu_torch.utils.weights import flax_classifier_to_state_dict
from torch_port_fixtures import one_torch_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _root_script(rel, name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _lines(text, pattern):
    return [m.groups() for m in re.finditer(pattern, text)]


def test_classifier_cli_matches_the_root_script(tmp_path, capsys):
    cohort = write_cohort(str(tmp_path / "cohort"))
    root = _root_script("Attention/grad_CAM_3d_sagittal.py", "root_grad_cam")
    flags = ["--dataroot", cohort, "--split", os.path.join(cohort, "vertebra_data_local.json"),
             "--gpu_ids", "-1"]
    train = ["train", "--steps", "3", "--batch", "2"] + flags
    root.main(train + ["--out", str(tmp_path / "jax_cls")])
    jax_out = capsys.readouterr().out

    # the root script's own init (PRNGKey(--seed 0)), carried across
    jparams = JaxClassifier().init(jax.random.PRNGKey(0), jnp.zeros((1, 128, 256, 5)))
    model = FractureClassifier(in_ch=5)
    model.load_state_dict(flax_classifier_to_state_dict(jax.device_get(jparams)))
    args = grad_cam_3d_sagittal.parse_args(train + ["--out", str(tmp_path / "port_cls")])
    stats = grad_cam_3d_sagittal.train(args, model, torch.device("cpu"))
    port_out = capsys.readouterr().out

    step = r"step (\d+): loss ([\d.]+) acc ([\d.]+)"
    (js, jl, ja), = _lines(jax_out, step)
    (ps, pl, pa), = _lines(port_out, step)
    assert (ps, pa) == (js, ja) and abs(float(pl) - float(jl)) <= 1e-4
    votes = r"(\w+) vertebra accuracy: ([\d.]+) \((\d+) verts\)"
    assert _lines(port_out, votes) == _lines(jax_out, votes) != []
    assert len(stats["loss"]) == 3 and np.isfinite(stats["loss"]).all()
    for d in ("jax_cls", "port_cls"):
        assert json.loads((tmp_path / d / "meta.json").read_text()) == {"z_context": 2,
                                                                        "band": 128}
    trained = jck.restore_checkpoint(jparams, str(tmp_path / "jax_cls"), "classifier")
    want = flax_classifier_to_state_dict(jax.device_get(trained))
    saved = torch.load(tmp_path / "port_cls" / "classifier.pt", weights_only=True)["classifier"]
    close = []
    for k, v in want.items():
        diff = np.abs(saved[k].numpy() - v.numpy())
        close.append((diff <= 1e-6 + 1e-4 * np.abs(v.numpy())).ravel())
        assert diff.max() <= 2 * args.steps * args.lr, k
    assert np.concatenate(close).mean() >= 0.99

    gen = ["generate"] + flags
    root.main(gen + ["--ckpt", str(tmp_path / "jax_cls"), "--out", str(tmp_path / "jax_cam")])
    grad_cam_3d_sagittal.main(gen + ["--ckpt", str(tmp_path / "port_cls"),
                                     "--out", str(tmp_path / "port_cam")])
    names = sorted(os.listdir(tmp_path / "jax_cam"))
    assert sorted(os.listdir(tmp_path / "port_cam")) == names and len(names) == 8
    for n in names:
        a = nifti.load(tmp_path / "port_cam" / n)
        b = nifti.load(tmp_path / "jax_cam" / n)
        assert a.data.shape == b.data.shape and np.array_equal(a.affine, b.affine)
        assert a.data.min() >= 0 and a.data.max() <= 1 + 1e-6 and a.data.max() > 0
        np.testing.assert_allclose(a.data, b.data, atol=1e-4, rtol=0, err_msg=n)


@pytest.mark.parametrize("z_context, band", [(0, 0), (2, 8), (2, 99), (1, 12)])
def test_slices_equal_the_root_script(z_context, band):
    """The classifier's inputs, all of a vertebra's (`_slices_for`) and the
    one that `train` builds (`_stack`), against the root script's, with the
    band clamped at the top edge and wider than the volume."""
    root = _root_script("Attention/grad_CAM_3d_sagittal.py", "root_grad_cam")
    rng = np.random.default_rng(0)
    ct = rng.integers(0, 255, (32, 16, 10)).astype(np.float32)
    labels = np.zeros((32, 16, 10), np.int16)
    labels[4:10, :, 1:9] = 20
    labels[20:26, :, 2:7] = 21
    for vid in (20, 21, 22):
        want = root._slices_for(ct, labels, vid, z_context=z_context, band=band)
        got = grad_cam_3d_sagittal._slices_for(ct, labels, vid, z_context=z_context, band=band)
        if want[0] is None:
            assert got == (None, None, 0)
            continue
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1:] == want[1:]
        idx, r0, b = grad_cam_3d_sagittal._slice_plan(labels, vid, band)
        for k, z in enumerate(idx):
            np.testing.assert_array_equal(
                grad_cam_3d_sagittal._stack(ct, z, r0, b, z_context), want[0][k])


def test_classifier_generate_without_or_with_a_jax_checkpoint(tmp_path, capsys):
    cohort = write_cohort(str(tmp_path / "cohort"))
    flags = ["generate", "--dataroot", cohort, "--split",
             os.path.join(cohort, "vertebra_data_local.json"), "--gpu_ids", "-1"]
    stats = grad_cam_3d_sagittal.main(flags + ["--out", str(tmp_path / "cam")])
    assert "warning: no classifier checkpoint" in capsys.readouterr().out
    assert len(stats["classes"]) == 8
    (tmp_path / "jax_only" / "classifier").mkdir(parents=True)
    with pytest.raises(RuntimeError, match="flax_classifier_to_state_dict"):
        grad_cam_3d_sagittal.main(flags + ["--ckpt", str(tmp_path / "jax_only"),
                                           "--out", str(tmp_path / "cam2")])


@pytest.fixture(scope="module")
def eval_cohort(tmp_path_factory):
    return write_eval_cohort(tmp_path_factory.mktemp("evalcli"))


def test_evaluation_clis_match_the_root_scripts(eval_cohort, tmp_path, capsys):
    r = eval_cohort
    common = ["--split", str(r / "split.json"), "--label_folder", str(r / "label"),
              "--output_folder", str(r / "output_3d")]
    jrhlv = _root_script("evaluation/RHLV_quantification.py", "root_rhlv")
    for axis, port_main, extra in (("sag", rhlv_quantification.main, []),
                                   ("cor", rhlv_quantification_coronal.main, ["--coronal"])):
        jrhlv.main(common + ["--result_folder", str(tmp_path / f"jax_{axis}")] + extra)
        port_main(common + ["--result_folder", str(tmp_path / f"port_{axis}")])
        for e in ("exp_sag", "exp_coronal"):
            want = (tmp_path / f"jax_{axis}" / f"{e}.csv").read_bytes()
            assert (tmp_path / f"port_{axis}" / f"{e}.csv").read_bytes() == want
            assert len(want.splitlines()) == 17
    capsys.readouterr()

    jsvm = _root_script("evaluation/SVM_grading.py", "root_svm")
    jsvm.main(["--result_folder", str(tmp_path / "jax_sag"),
               "--grading_folder", str(tmp_path / "jax_grades")])
    jax_out = capsys.readouterr().out
    svm_grading.main(["--result_folder", str(tmp_path / "jax_sag"),
                      "--grading_folder", str(tmp_path / "port_grades")])
    port_out = capsys.readouterr().out
    assert port_out.replace("port_grades", "jax_grades") == jax_out
    for e in ("exp_sag", "exp_coronal"):
        assert ((tmp_path / "port_grades" / f"{e}.txt").read_bytes()
                == (tmp_path / "jax_grades" / f"{e}.txt").read_bytes())

    j25 = _root_script("evaluation/SVM_grading_2.5d.py", "root_svm_25d")
    pair = ["--sagittal", str(tmp_path / "jax_sag" / "exp_sag.csv"),
            "--coronal", str(tmp_path / "jax_cor" / "exp_sag.csv")]
    j25.main(pair + ["--output", str(tmp_path / "jax25.txt")])
    svm_grading_2_5d.main(pair + ["--output", str(tmp_path / "port25.txt")])
    out = capsys.readouterr().out.splitlines()
    assert out[1] == out[3] and out[1].startswith("2.5D macro-F1")
    assert (tmp_path / "port25.txt").read_bytes() == (tmp_path / "jax25.txt").read_bytes()

    jgen = _root_script("evaluation/generation_eval_sagittal.py", "root_geneval")
    gen = ["--split", str(r / "split.json"), "--ct_folder", str(r / "CT"),
           "--label_folder", str(r / "label"), "--output_folder", str(r / "output_3d"),
           "--gpu_ids", "-1"]
    for axis, port_main, extra, exps in (
            ("sag", generation_eval_sagittal.main, [], ("exp_coronal", "exp_sag")),
            ("cor", generation_eval_coronal.main, ["--coronal"], ("exp_coronal",))):
        jgen.main(gen + ["--result_folder", str(tmp_path / f"jgen_{axis}")] + extra)
        got = port_main(gen + ["--result_folder", str(tmp_path / f"pgen_{axis}")])
        assert sorted(os.listdir(tmp_path / f"pgen_{axis}")) == [f"{e}.txt" for e in exps]
        assert sorted(os.listdir(tmp_path / f"jgen_{axis}")) == [f"{e}.txt" for e in exps]
        for e in exps:
            want = dict(ln.split(": ") for ln in
                        (tmp_path / f"jgen_{axis}" / f"{e}.txt").read_text().splitlines())
            text = (tmp_path / f"pgen_{axis}" / f"{e}.txt").read_text().splitlines()
            have = dict(ln.split(": ") for ln in text)
            assert list(have) == list(want) and have["count"] == want["count"] == "2"
            for k in want:
                np.testing.assert_allclose(float(have[k]), float(want[k]), rtol=1e-5, err_msg=k)
            assert got[str(tmp_path / f"pgen_{axis}" / f"{e}.txt")]["count"] == 2
