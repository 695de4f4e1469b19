"""Port vs JAX package: the command-line options.

For train and test argv sets (plugin defaults of pix2pix, --suffix, the
train CLI's known_only second parse of the eval split) `vars(opt)` equals
the JAX package's, apart from the port's `device`, and the saved
{phase}_opt.txt is the same text byte for byte. --gpu_ids -1 selects the
CPU; the default (card 0) raises without a card. Each flag whose feature
the port lacks (--netD seg, a model mesh axis, an unknown --lr_policy)
raises NotImplementedError naming ROADMAP.md; the multi-GPU flags (--mesh
data:2, several --gpu_ids) and --remat parse, and the CLIs take them.
"""

import pytest
import torch

from healthivert_tpu.config import options as jopts
from healthivert_tpu_torch.config import options as popts

TRAIN_ARGV = [
    ["--dataroot", "data", "--name", "exp"],
    ["--dataset_mode", "synthetic", "--batch_size", "32", "--compute_dtype", "bfloat16",
     "--lambda_L1", "100", "--no-crop_d3", "--suffix", "{batch_size}_{netD}", "--netD",
     "pixel", "--lr_policy", "plateau", "--save_by_iter", "--profile_steps", "3,5"],
    ["--gpu_ids", "-1", "--max_steps", "7", "--norm", "instance", "--gan_mode", "lsgan",
     "--continue_train", "--load_iter", "12", "--cam_dir", "cams", "--data_cache_gb", "0"],
]
TEST_ARGV = [
    ["--dataroot", "data", "--name", "exp"],
    ["--num_test", "5", "--aspect_ratio", "2.0", "--compute_dtype", "float32", "--epoch", "3",
     "--suffix", "{phase}"],
]


def _both(cls_name, argv, tmp_path, monkeypatch, **kw):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    dirs = [str(tmp_path / "jax"), str(tmp_path / "port")]
    j = getattr(jopts, cls_name)().parse(argv + ["--checkpoints_dir", dirs[0]], **kw)
    p = getattr(popts, cls_name)().parse(argv + ["--checkpoints_dir", dirs[1]], **kw)
    return j, p


def _same(j, p):
    pv = dict(vars(p))
    pv.pop("device")
    jv = dict(vars(j))
    jv["checkpoints_dir"] = pv["checkpoints_dir"]
    assert pv == jv


@pytest.mark.parametrize("i", range(len(TRAIN_ARGV)))
def test_train_options_and_opt_txt_equal(tmp_path, monkeypatch, i):
    j, p = _both("TrainOptions", TRAIN_ARGV[i], tmp_path, monkeypatch)
    _same(j, p)
    jt = (tmp_path / "jax" / j.name / "train_opt.txt").read_text()
    pt = (tmp_path / "port" / p.name / "train_opt.txt").read_text()
    assert pt == jt.replace(str(tmp_path / "jax"), str(tmp_path / "port"))
    assert p.device == torch.device("cpu" if "-1" in TRAIN_ARGV[i] else "cuda:0")


@pytest.mark.parametrize("i", range(len(TEST_ARGV)))
def test_test_options_and_opt_txt_equal(tmp_path, monkeypatch, i):
    j, p = _both("TestOptions", TEST_ARGV[i], tmp_path, monkeypatch)
    _same(j, p)
    jt = (tmp_path / "jax" / j.name / "test_opt.txt").read_text()
    pt = (tmp_path / "port" / p.name / "test_opt.txt").read_text()
    assert pt == jt.replace(str(tmp_path / "jax"), str(tmp_path / "port"))
    assert p.compute_dtype == j.compute_dtype


def test_known_only_second_parse_equal(tmp_path, monkeypatch):
    argv = TRAIN_ARGV[1] + ["--print_freq", "10", "--lr", "0.001"]
    j, p = _both("TestOptions", argv, tmp_path, monkeypatch, save=False, known_only=True)
    _same(j, p)
    assert not (tmp_path / "port").exists()


def test_gpu_ids_select_the_device(tmp_path):
    opt = popts.TrainOptions().parse(["--gpu_ids", "-1", "--checkpoints_dir", str(tmp_path)],
                                     save=False)
    assert opt.device == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--gpu_ids -1"):
            popts.TrainOptions().parse(["--checkpoints_dir", str(tmp_path)], save=False)
    with pytest.raises(SystemExit):
        popts.device_from_gpu_ids("0,x")


FLAGS = [["--mesh", "data:2"], ["--mesh", "data:-1,model:2"], ["--remat"], ["--netD", "seg"],
         ["--lr_policy", "exponential"], ["--gpu_ids", "0,1"]]
RAISE = ("--lr_policy exponential",)


@pytest.mark.parametrize("argv", FLAGS, ids=lambda a: " ".join(a))
def test_unported_flags_raise(tmp_path, monkeypatch, argv):
    """--lr_policy exponential, which neither package runs, raises; the
    flags of features that raised until they were ported (multi-GPU with a
    model axis, --remat, --netD seg) now parse and the CLIs take them."""
    from healthivert_tpu_torch.cli import eval_3d_sagittal_twostage as e3_cli
    from healthivert_tpu_torch.cli.train import check_mesh
    from healthivert_tpu_torch.engine.train_loop import config_from_opt

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    parse = lambda: popts.TrainOptions().parse(
        argv + ["--checkpoints_dir", str(tmp_path)], save=False)
    if " ".join(argv) in RAISE:
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            parse()
        return
    opt = parse()
    if argv[0] == "--mesh":  # the train CLI takes it under torchrun, else names it
        check_mesh(opt.mesh, 2)
        with pytest.raises(SystemExit, match="torchrun --standalone --nproc_per_node 2"):
            check_mesh(opt.mesh, 1)
        if "model" in opt.mesh:  # data x model processes
            check_mesh(opt.mesh, 4)
            with pytest.raises(SystemExit, match="asks for 2 processes"):
                check_mesh(opt.mesh, 3)  # data:-1 takes 3 // 2 shards, as in JAX
    elif argv[0] == "--remat":
        assert config_from_opt(opt).remat
    elif argv[0] == "--netD":
        assert config_from_opt(opt).net_d == "seg"
    else:  # each torchrun process takes its card; the 3D CLI shards over both
        assert opt.device == torch.device("cuda:0")
        monkeypatch.setenv("LOCAL_RANK", "1")
        assert parse().device == torch.device("cuda:1")
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
        mesh = e3_cli.card_mesh(opt)
        assert mesh.shape == {"data": 2}
        assert mesh.devices == (torch.device("cuda:0"), torch.device("cuda:1"))
        monkeypatch.setenv("LOCAL_RANK", "2")
        with pytest.raises(SystemExit, match="one id per process"):
            parse()
