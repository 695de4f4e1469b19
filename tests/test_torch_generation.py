"""The port's generation metrics (healthivert_tpu_torch/evaluation/
generation.py, PSNR/SSIM through ops/image.psnr_ssim_batch on the CPU
here) against the JAX package's (healthivert_tpu/evaluation/generation.py)
on synthetic straightened volumes (128 x 128 x 32): every metric of
`process_images` and every average of `evaluate_experiment` within rtol
1e-5, sagittal and coronal, with the grade == 0 filter (a grade-1 vertebra
left out) and the skip of a vertebra whose label volume lacks its id."""

import numpy as np
import pytest

from healthivert_tpu.evaluation import generation as jgen
from healthivert_tpu_torch.data.synthetic import make_spine_volume
from healthivert_tpu_torch.evaluation import generation
from healthivert_tpu_torch.utils import nifti
from torch_port_fixtures import one_torch_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SPLIT = {"a_20": 0, "b_20": 0, "c_20": 1, "d_20": 0, "e_21": 0}


@pytest.fixture(scope="module")
def exp(tmp_path_factory):
    """CT/, label/ and exp/{CT_fake,label_fake}/: a noisy fake of a healthy
    spine against real spines (b_20 compressed); d_20's label volume lacks
    vertebra 20; e_21 has no fake."""
    root = tmp_path_factory.mktemp("gen")
    for d in ("CT", "label", "exp/CT_fake", "exp/label_fake"):
        (root / d).mkdir(parents=True)
    rng = np.random.default_rng(0)
    kw = dict(shape=(128, 128, 32), vert_ids=(19, 20, 21), vert_height=18, gap=8)
    for pv in SPLIT:
        ct, lb, _ = make_spine_volume(rng, fractured={20: 0.6} if pv == "b_20" else None, **kw)
        fake_ct, fake_lb, _ = make_spine_volume(rng, **kw)
        fake_ct = np.clip(fake_ct + rng.normal(0, 6, fake_ct.shape), 0, 255)
        if pv == "d_20":
            lb = np.where(lb == 20, 0, lb)
        nifti.save(nifti.Nifti1Image(ct.astype(np.float32)), str(root / "CT" / f"{pv}.nii.gz"))
        nifti.save(nifti.Nifti1Image(lb.astype(np.int16)), str(root / "label" / f"{pv}.nii.gz"))
        if pv != "e_21":
            nifti.save(nifti.Nifti1Image(fake_ct.astype(np.float32)),
                       str(root / "exp" / "CT_fake" / f"{pv}.nii.gz"))
            nifti.save(nifti.Nifti1Image(fake_lb.astype(np.float32)),
                       str(root / "exp" / "label_fake" / f"{pv}.nii.gz"))
    return root


@pytest.mark.parametrize("axis", [2, 1])
def test_process_images(exp, axis):
    paths = [str(exp / "CT" / "b_20.nii.gz"), str(exp / "exp" / "CT_fake" / "b_20.nii.gz"),
             str(exp / "label" / "b_20.nii.gz"), str(exp / "exp" / "label_fake" / "b_20.nii.gz")]
    want = jgen.process_images(*paths, axis=axis)
    got = generation.process_images(*paths, axis=axis, device="cpu")
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    assert 0 < got["patch_ssim"] < 1 and got["patch_psnr"] > 0 and 0 < got["dice"] < 1


@pytest.mark.parametrize("axis", [2, 1])
def test_evaluate_experiment(exp, tmp_path, axis):
    args = (SPLIT, str(exp / "CT"), str(exp / "label"), str(exp / "exp"))
    want = jgen.evaluate_experiment(*args, str(tmp_path / "jax.txt"), axis=axis)
    got = generation.evaluate_experiment(*args, str(tmp_path / "port.txt"), axis=axis,
                                         device="cpu")
    assert got["count"] == want["count"] == 2  # a_20, b_20: c_20 grade 1, d_20 degenerate
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    lines = (tmp_path / "port.txt").read_text().splitlines()
    assert [ln.split(":")[0] for ln in lines] == list(want)


def test_metric_rows_guards():
    """NaN where the data range is not positive (both metrics) or a side is
    under the 7-pixel window (SSIM), as in the JAX package."""
    rng = np.random.default_rng(2)
    a = rng.uniform(0, 255, (2, 6, 20)).astype(np.float32)
    rows = [(a[0], a[1], float(a[0].max() - a[0].min())), (a[1], a[0], 0.0)]
    p, s = generation._metric_rows(rows, device="cpu")
    pj, sj = jgen._metric_rows(rows)
    np.testing.assert_allclose(p[0], pj[0], rtol=1e-5)
    assert np.isnan(p[1]) and np.isnan(pj[1]) and all(np.isnan(s)) and all(np.isnan(sj))
    assert generation._metric_rows([], device="cpu") == ([], [])
