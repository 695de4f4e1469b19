"""The port's CLIs on the card (marked `cuda`; each test decides at run
time whether there is a card, and skips without one). On the machine with
the card, which has no JAX, leave out the repository's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_cli.py

- the 3D synthesis CLI (bf16, its default) on the cohort of
  tests/cli_cohort.py equals synthesize_volumes called on the card with
  the same generator and volumes, bit for bit, with one tensor-core launch
  per dispatch;
- a train CLI run resumed with --continue_train continues the step count.
"""

import numpy as np
import pytest
import torch

from cli_cohort import NPZ, write_cohort
from healthivert_tpu_torch.cli import eval_3d_sagittal_twostage as e3
from healthivert_tpu_torch.cli import train as train_cli
from healthivert_tpu_torch.engine import infer3d
from healthivert_tpu_torch.engine.checkpoint import load_generator
from healthivert_tpu_torch.models.pix2pix import Pix2PixConfig
from healthivert_tpu_torch.ops.attention_cuda import attention_v2
from healthivert_tpu_torch.utils import nifti

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    return torch.device("cuda")


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
