"""The port's training loop on the CPU (synthetic data, ngf=16 as the
reference hard-codes, ndf=8, 64 x 64, batch 2), for what the CLI parity
tests do not reach: the --profile_steps window (flushed when the run ends
first, flushed on divergence, opened when a resume lands inside it; its
START,STOP parsing; the trace's launches without a kernel record counted),
the display_freq web gallery, and the evaluation's
-SSIM reaching the plateau policy. The same semantics as the JAX loop's
(tests/test_cli_surfaces.py holds those).
"""

import json
import types

import pytest

from healthivert_tpu_torch.cli.train import parse_profile_steps
from healthivert_tpu_torch.engine import train_loop
from healthivert_tpu_torch.engine.train_loop import run_training
from torch_port_fixtures import one_torch_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _opt(tmp_path, **kw):
    base = dict(
        dataset_mode="synthetic", batch_size=2, seed=3, crop_size=64, ndf=8, lr=2e-4,
        beta1=0.5, gan_mode="vanilla", epoch_count=1, n_epochs=5, n_epochs_decay=5,
        lr_policy="linear", print_freq=2, compute_dtype="float32", name="run",
        checkpoints_dir=str(tmp_path), save_latest_freq=5000, save_epoch_freq=5,
        save_by_iter=False, display_freq=0, epoch="latest", load_iter=0,
    )
    base.update(kw)
    return types.SimpleNamespace(**base)


def _trace(tmp_path):
    return tmp_path / "run" / "profile" / "trace.json"


def test_profile_window_flushed_when_the_run_ends_first(tmp_path, capsys):
    run_training(_opt(tmp_path), max_steps=2, profile_steps=(0, 100), device="cpu")
    assert _trace(tmp_path).stat().st_size > 0
    assert "truncated at run end" in capsys.readouterr().out


def test_profile_window_prints_its_kernel_records(tmp_path, capsys):
    run_training(_opt(tmp_path), max_steps=3, profile_steps=(1, 2), device="cpu")
    out = capsys.readouterr().out
    assert _trace(tmp_path).exists() and "truncated" not in out
    assert "0 kernel launches, 0 without a kernel record" in out  # no card: no launches


def test_trace_kernel_records_matches_launches_by_correlation(tmp_path):
    def ev(cat, name, corr):
        return {"ph": "X", "cat": cat, "name": name, "args": {"correlation": corr}}

    trace = tmp_path / "trace.json"
    trace.write_text(json.dumps({"traceEvents": [
        ev("cuda_runtime", "cudaLaunchKernel", 1), ev("kernel", "gemm", 1),
        ev("cuda_runtime", "cudaLaunchKernelExC", 2), ev("cuda_driver", "cuLaunchKernel", 3),
        ev("kernel", "split", 3), ev("cuda_runtime", "cudaMemcpyAsync", 4),
        ev("gpu_memcpy", "Memcpy HtoD", 4), {"ph": "M", "name": "process_name"}]}))
    assert train_loop.trace_kernel_records(trace) == (3, 1)


def test_profile_window_flushed_on_divergence(tmp_path, capsys):
    with pytest.raises(FloatingPointError):
        run_training(_opt(tmp_path, lr=1e30, beta1=0.0), max_steps=3, profile_steps=(0, 100),
                     device="cpu")
    assert _trace(tmp_path).exists()
    assert "divergence abort" in capsys.readouterr().out


def test_profile_window_opens_on_a_resume_inside_it(tmp_path, capsys):
    run_training(_opt(tmp_path), max_steps=2, device="cpu")
    assert not _trace(tmp_path).exists()
    state, _ = run_training(_opt(tmp_path, continue_train=True), max_steps=3,
                            profile_steps=(1, 3), device="cpu")
    out = capsys.readouterr().out
    assert state.step == 3 and "at step 2" in out
    assert _trace(tmp_path).exists() and "truncated" not in out
    # a window wholly before the resume step writes nothing
    _trace(tmp_path).unlink()
    run_training(_opt(tmp_path, continue_train=True), max_steps=4, profile_steps=(0, 2),
                 device="cpu")
    assert not _trace(tmp_path).exists()
    assert "entirely before the resume step 3" in capsys.readouterr().out


def test_profile_steps_parsing():
    assert parse_profile_steps(None) is None
    assert parse_profile_steps("3,5") == (3, 5)
    assert parse_profile_steps("4") == (4, 14)
    for bad in ("x", "5,5", "-1,2", "3,a"):
        with pytest.raises(SystemExit):
            parse_profile_steps(bad)


def test_web_gallery_and_plateau_metric(tmp_path, monkeypatch):
    metrics = []
    scale = train_loop.LRSchedule.scale

    def spy(self, epoch, metric=None):
        metrics.append(metric)
        return scale(self, epoch, metric)

    monkeypatch.setattr(train_loop.LRSchedule, "scale", spy)
    opt = _opt(tmp_path, display_freq=2, lr_policy="plateau", eval_freq=1)
    opt_test = _opt(tmp_path, batch_size=3)
    opt_test.synthetic_cache = 0
    ds_batches = 64 // 2
    run_training(opt, opt_test, max_steps=ds_batches + 1, device="cpu")
    web = tmp_path / "run" / "web"
    assert (web / "index.html").exists()
    assert len(list((web / "images").glob("epoch001_*_fake_B.png"))) == ds_batches
    assert metrics[0] is None and metrics[1] < 0  # epoch 2 reads epoch 1's -SSIM
