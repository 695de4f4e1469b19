"""The port's train CLI against the root train.py of the JAX package, end to
end on the CPU (--gpu_ids -1, float32, --crop_size 64, --batch_size 2,
--ndf 8, one epoch) on the cohort of tests/cli_cohort.py, both starting
from one set of reference .pth files (--load_pth: G and the sibling
D_1-D_3, random weights drawn from a seed).

The train split holds five normal vertebrae, so the epoch's three steps end
on a trailing batch of one, which both loops pad to two by cyclic
repetition: the batches that reach train_step are equal, and full. The 13
losses of each step in metrics.jsonl agree to rtol 1e-4 (as
tests/test_torch_train_step.py: ~60 float32 convs and a softmax between
the batch and the losses). The learning rate of the only epoch is 0
(--n_epochs 1 --n_epochs_decay 0, the linear policy), so the eval after it
reads the loaded generator: SSIM and PSNR rtol 1e-4, Dice and IoU within
0.02 / (samples) (a pixel on the seg's 0.5 threshold may flip; see
tests/test_torch_evaluate.py), diff_h rtol 1e-4. A --continue_train run of
the port resumes from its 'latest' checkpoint and continues the step count.
"""

import json
import os

import numpy as np
import pytest
import torch

import train as jax_train
from cli_cohort import skip_jax_init, write_cohort
from healthivert_tpu.engine import train_loop as jax_loop
from healthivert_tpu_torch.cli import train as train_cli
from healthivert_tpu_torch.engine import checkpoint as ckpt
from healthivert_tpu_torch.engine import train_loop
from torch_port_fixtures import d_tree_to_reference_sd, g_tree_to_reference_sd, random_train_trees
from torch_port_fixtures import one_torch_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

FLAGS = ["--gpu_ids", "-1", "--crop_size", "64", "--batch_size", "2", "--ndf", "8",
         "--max_steps", "3", "--print_freq", "2", "--eval_freq", "1", "--n_epochs", "1",
         "--n_epochs_decay", "0", "--mesh", "data:1", "--name", "run"]
LOSSES = ["G_GAN", "G_maskL1", "G_Dice", "coarse_Dice", "edge", "h", "D_real_1", "D_fake_1",
          "D_real_2", "D_fake_2", "D_real_3", "D_fake_3", "G_total"]


def _records(run_dir, tag):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [r for r in map(json.loads, f) if r["tag"] == tag]


def _recording(monkeypatch, module, seen):
    step = module.train_step

    def wrapped(state, batch, *a, **kw):
        seen.append({k: np.asarray(v) for k, v in batch.items()})
        return step(state, batch, *a, **kw)

    monkeypatch.setattr(module, "train_step", wrapped)


def test_train_cli_matches_the_root_cli_and_resumes(tmp_path, monkeypatch, capsys):
    cohort = write_cohort(str(tmp_path / "cohort"))
    trees = random_train_trees(ngf=16, ndf=8, image_size=64, seed=1)
    torch.save(g_tree_to_reference_sd(trees["g_params"], trees["g_sn"]),
               tmp_path / "7_net_G.pth")
    for i in (1, 2, 3):
        torch.save(d_tree_to_reference_sd(trees[f"d{i}_params"], trees[f"d{i}_stats"]),
                   tmp_path / f"7_net_D_{i}.pth")
    common = FLAGS + ["--dataroot", cohort, "--load_pth", str(tmp_path / "7_net_G.pth")]
    skip_jax_init(monkeypatch, jax_loop)
    seen_jax, seen_port = [], []
    _recording(monkeypatch, jax_loop, seen_jax)
    _recording(monkeypatch, train_loop, seen_port)
    jax_train.main(common + ["--checkpoints_dir", str(tmp_path / "jax")])
    state, _ = train_cli.main(common + ["--checkpoints_dir", str(tmp_path / "port")])
    assert state.step == 3

    assert len(seen_port) == len(seen_jax) == 3
    for bp, bj in zip(seen_port, seen_jax):
        assert bp.keys() == bj.keys()
        for k in bj:
            assert bp[k].shape[0] == 2 and np.array_equal(bp[k], bj[k]), k
    assert np.array_equal(seen_port[2]["full"][0], seen_port[2]["full"][1])  # the padding

    jdir, pdir = tmp_path / "jax" / "run", tmp_path / "port" / "run"
    train_j, train_p = _records(jdir, "train"), _records(pdir, "train")
    assert [r["step"] for r in train_p] == [r["step"] for r in train_j] == [2, 4, 6]
    for rp, rj in zip(train_p, train_j):
        for k in LOSSES:
            np.testing.assert_allclose(rp[k], rj[k], rtol=1e-4, err_msg=k)
    (ej,), (ep,) = _records(jdir, "eval"), _records(pdir, "eval")
    for k in ("ssim", "psnr", "diff_h"):
        np.testing.assert_allclose(ep[k], ej[k], rtol=1e-4, err_msg=k)
    for k in ("dice", "iou"):
        assert abs(ep[k] - ej[k]) <= 0.02 / 2, (k, ep[k], ej[k])
    assert (pdir / "eval_imgs" / "nepoch_001_eval.png").exists()
    assert (pdir / "loss_log.txt").read_text().count("(epoch: 1, iters:") == 3
    assert sorted(p.name for p in pdir.glob("*.pt")) == ["1.pt", "latest.pt"]

    capsys.readouterr()
    resumed, _ = train_cli.main(FLAGS + ["--max_steps", "4", "--dataroot", cohort,
                                         "--continue_train",
                                         "--checkpoints_dir", str(tmp_path / "port")])
    assert "at step 3" in capsys.readouterr().out
    assert resumed.step == 4
    assert torch.load(pdir / "latest.pt", weights_only=True)["step"] == 4
    assert ckpt.latest_exists(pdir, "latest") and ckpt.latest_exists(pdir, 1)


def test_continue_train_from_an_orbax_run_raises(tmp_path):
    cohort = write_cohort(str(tmp_path / "cohort"))
    (tmp_path / "ck" / "run" / "latest").mkdir(parents=True)
    with pytest.raises(RuntimeError, match="--load_npz"):
        train_cli.main(FLAGS + ["--dataroot", cohort, "--continue_train",
                                "--checkpoints_dir", str(tmp_path / "ck")])
