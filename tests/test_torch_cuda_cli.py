"""The port's CLIs on the card (marked `cuda`; each test decides at run
time whether there is a card, and skips without one). On the machine with
the card, which has no JAX, leave out the repository's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_cli.py

- the 3D synthesis CLI (bf16, its default) on the cohort of
  tests/cli_cohort.py equals synthesize_volumes called on the card with
  the same generator and volumes, bit for bit, with one tensor-core launch
  per dispatch;
- a train CLI run resumed with --continue_train continues the step count;
- the classifier CLI (grad_cam_3d_sagittal) on the card against
  --gpu_ids -1: `train` from one init, the losses within 1e-4 and the same
  held-out votes; `generate` from one checkpoint, the same class suffixes
  and CAMs within atol 1e-4;
- generation_eval_sagittal on the card against --gpu_ids -1 on the cohort
  of cli_cohort.write_eval_cohort: every average within rtol 1e-4;
- straighten_mask_3d --reorient RAI on the card against --gpu_ids -1 on the
  raw cohort of straighten_cohort.py: label and mask_2d crops bit-equal, CT
  crops within 1e-3;
- the float32 train CLI's --profile_steps trace holds a kernel record for
  every kernel launch.

The CLIs compared with the CPU run with PyTorch's TF32 defaults (cuDNN
convolutions in TF32) before them, as a user's process has them: each CLI
sets exact float32 itself (utils.device.float32_exact), and must leave it.
"""

import os

import numpy as np
import pytest
import torch

from cli_cohort import NPZ, write_cohort, write_eval_cohort
from healthivert_tpu_torch.cli import eval_3d_sagittal_twostage as e3
from healthivert_tpu_torch.cli import (
    generation_eval_sagittal,
    grad_cam_3d_sagittal,
    location_json_local,
    straighten_mask_3d,
)
from healthivert_tpu_torch.cli import train as train_cli
from healthivert_tpu_torch.engine import infer3d
from healthivert_tpu_torch.engine.train_loop import trace_kernel_records
from healthivert_tpu_torch.engine.checkpoint import load_generator
from healthivert_tpu_torch.models.pix2pix import Pix2PixConfig
from healthivert_tpu_torch.ops.attention_cuda import attention_v2
from healthivert_tpu_torch.utils import nifti
from straighten_cohort import SIZE, write_raw_cohort

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    return torch.device("cuda")


@pytest.fixture
def tf32_defaults(cuda_device):
    """PyTorch's own float32 settings before the test's CLIs (cuDNN
    convolutions in TF32, CUDA matmuls not), put back after it."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = True, False
    yield cuda_device
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def _assert_exact_float32():
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.backends.cuda.matmul.allow_tf32 is False


def test_eval_3d_cli_equals_synthesize_volumes(cuda_device, tmp_path):
    cohort = write_cohort(str(tmp_path / "cohort"))
    attention_v2.launches = attention_v2.tc_launches = 0
    infer3d._forward.dispatches = 0
    e3.main(["--dataroot", cohort, "--crop_size", "64", "--checkpoints_dir", str(tmp_path / "ck"),
             "--results_dir", str(tmp_path / "out"), "--slice_batch", "16", "--load_npz", NPZ])
    assert attention_v2.tc_launches == attention_v2.launches == infer3d._forward.dispatches > 0
    cfg = Pix2PixConfig(ngf=16, image_size=64, compute_dtype="bfloat16")
    gen = load_generator(NPZ, cfg, device=cuda_device)
    for p in range(4):
        names = [f"p{p}_{v}.nii.gz" for v in (20, 21)]
        vols = [(nifti.load(f"{cohort}/CT/{n}").get_fdata(),
                 nifti.load(f"{cohort}/label/{n}").get_fdata(), v, None)
                for n, v in zip(names, (20, 21))]
        direct = infer3d.synthesize_volumes(gen, cfg, vols, batch_size=16, device=cuda_device)
        for n, (ct, lb) in zip(names, direct):
            np.testing.assert_array_equal(nifti.load(tmp_path / "out" / "CT_fake" / n).data,
                                          ct.astype(np.float32))
            np.testing.assert_array_equal(nifti.load(tmp_path / "out" / "label_fake" / n).data,
                                          lb.astype(np.float32))


def test_train_cli_resume_continues(cuda_device, tmp_path):
    cohort = write_cohort(str(tmp_path / "cohort"))
    flags = ["--dataroot", cohort, "--crop_size", "64", "--batch_size", "2", "--ndf", "8",
             "--checkpoints_dir", str(tmp_path / "ck"), "--compute_dtype", "bfloat16",
             "--eval_freq", "1", "--load_npz", NPZ]
    state, _ = train_cli.main(flags + ["--max_steps", "2"])
    assert state.step == 2
    resumed, _ = train_cli.main(flags + ["--max_steps", "3", "--continue_train"])
    assert resumed.step == 3
    saved = torch.load(tmp_path / "ck" / "experiment_name" / "latest.pt", weights_only=True)
    assert saved["step"] == 3


def test_classifier_cli_card_equals_cpu(tf32_defaults, tmp_path):
    cohort = write_cohort(str(tmp_path / "cohort"))
    flags = ["--dataroot", cohort, "--split", f"{cohort}/vertebra_data_local.json"]
    train = ["train", "--steps", "3", "--batch", "2"] + flags
    runs = {}
    for ids in ("0", "-1"):
        runs[ids] = grad_cam_3d_sagittal.main(train + ["--out", str(tmp_path / f"cls{ids}"),
                                                       "--gpu_ids", ids])
    _assert_exact_float32()
    np.testing.assert_allclose(runs["0"]["loss"], runs["-1"]["loss"], atol=1e-4)
    assert runs["0"]["vote_accuracy"] == runs["-1"]["vote_accuracy"]
    gen = {}
    for ids in ("0", "-1"):
        gen[ids] = grad_cam_3d_sagittal.main(
            ["generate"] + flags + ["--ckpt", str(tmp_path / "cls-1"),
                                    "--out", str(tmp_path / f"cam{ids}"), "--gpu_ids", ids])
    assert gen["0"]["classes"] == gen["-1"]["classes"] and len(gen["0"]["classes"]) == 8
    for pv, cls in gen["0"]["classes"].items():
        a = nifti.load(tmp_path / "cam0" / f"{pv}_{cls}.nii.gz").data
        b = nifti.load(tmp_path / "cam-1" / f"{pv}_{cls}.nii.gz").data
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=0, err_msg=pv)


def test_generation_eval_card_equals_cpu(tf32_defaults, tmp_path):
    r = write_eval_cohort(tmp_path / "cohort")
    flags = ["--split", str(r / "split.json"), "--ct_folder", str(r / "CT"),
             "--label_folder", str(r / "label"), "--output_folder", str(r / "output_3d")]
    card = generation_eval_sagittal.main(flags + ["--result_folder", str(tmp_path / "card")])
    _assert_exact_float32()
    cpu = generation_eval_sagittal.main(flags + ["--result_folder", str(tmp_path / "cpu"),
                                                 "--gpu_ids", "-1"])
    assert len(card) == len(cpu) == 2
    for (pc, c), (pp, p) in zip(sorted(card.items()), sorted(cpu.items())):
        assert os.path.basename(pc) == os.path.basename(pp) and list(c) == list(p)
        assert c["count"] == p["count"] == 2
        for k in p:
            np.testing.assert_allclose(c[k], p[k], rtol=1e-4, err_msg=k)


def test_straighten_cli_card_equals_cpu(tf32_defaults, tmp_path):
    raw = write_raw_cohort(str(tmp_path / "raw"))
    location_json_local.main(["--root", raw])
    flags = ["--root", raw, "--size", *SIZE, "--reorient", "RAI"]
    card = straighten_mask_3d.main(flags + ["--out", str(tmp_path / "card")])
    _assert_exact_float32()
    cpu = straighten_mask_3d.main(flags + ["--out", str(tmp_path / "cpu"), "--gpu_ids", "-1"])
    assert card == cpu and len(card) == 14
    for n in card:
        for kind in ("CT", "label", "mask_2d"):
            a = nifti.load(tmp_path / "card" / kind / f"{n}.nii.gz")
            b = nifti.load(tmp_path / "cpu" / kind / f"{n}.nii.gz")
            np.testing.assert_array_equal(a.affine, b.affine)
            if kind == "CT":
                np.testing.assert_allclose(a.data, b.data, rtol=0, atol=1e-3, err_msg=n)
            else:
                np.testing.assert_array_equal(a.data, b.data, err_msg=f"{kind}/{n}")


def test_train_cli_profile_trace_holds_every_kernel(tf32_defaults, tmp_path):
    """A trace of steps 2-3 (float32, the CLI's default): one step of
    warm-up before it, not recorded, and a kernel record for every launch."""
    cohort = write_cohort(str(tmp_path / "cohort"))
    state, cfg = train_cli.main(["--dataroot", cohort, "--crop_size", "64", "--batch_size", "2",
                                 "--ndf", "8", "--checkpoints_dir", str(tmp_path / "ck"),
                                 "--load_npz", NPZ, "--max_steps", "5", "--profile_steps", "2,4"])
    _assert_exact_float32()
    assert cfg.compute_dtype == "float32" and state.step == 5
    launches, lost = trace_kernel_records(
        tmp_path / "ck" / "experiment_name" / "profile" / "trace.json")
    assert launches > 100 and lost == 0
