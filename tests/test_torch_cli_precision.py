"""Every CLI of the port sets exact float32 before it does anything else
(utils.device.float32_exact): TF32 off for cuDNN convolutions and CUDA
matmuls, through the legacy flags only, so that a read of them after the
CLI does not meet PyTorch's refusal of a mix of its two TF32 APIs. Each
CLI runs as far as --help, with PyTorch's defaults (cuDNN TF32 on) before
it."""

import importlib

import pytest
import torch

CLIS = ["eval_3d_sagittal_twostage", "train", "test", "grad_cam_3d_sagittal",
        "generation_eval_sagittal", "generation_eval_coronal", "rhlv_quantification",
        "rhlv_quantification_coronal", "svm_grading", "svm_grading_2_5d",
        "location_json_local", "straighten_mask_3d"]


@pytest.fixture
def tf32_defaults():
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = True, False
    yield
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


@pytest.mark.parametrize("name", CLIS)
def test_cli_main_sets_exact_float32(name, tf32_defaults, capsys):
    cli = importlib.import_module(f"healthivert_tpu_torch.cli.{name}")
    with pytest.raises(SystemExit) as stop:
        cli.main(["--help"])
    assert stop.value.code == 0 and "usage" in capsys.readouterr().out
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.backends.cuda.matmul.allow_tf32 is False
