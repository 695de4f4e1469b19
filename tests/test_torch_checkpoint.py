"""The port's checkpoints: its own training-state format, resume, and the
reference's .pth files held against the JAX package's reader.

- save, then restore into a state initialised from another seed: every
  parameter, buffer (spectral-norm u, BatchNorm running statistics), Adam
  state (moments and step) and the step are equal;
- 4 train steps equal 2 steps + save + restore into a fresh state + 2
  steps, exactly (ngf=4, ndf=8, 64 x 64, batch 2, float32, CPU);
- resolve_tag, the atomic write, and the generator-only file;
- a .pth written in the reference's layout gives the port's G and D state
  dicts equal to utils/weights.py's conversion of the trees that the JAX
  package's load_generator_pth / load_discriminator_pth return; a bad
  shape or an unknown key raises.
"""

import copy
import types

import numpy as np
import pytest
import torch

from healthivert_tpu.data.synthetic import SyntheticDataset
from healthivert_tpu.utils import pth as jpth
from healthivert_tpu_torch.engine import checkpoint as ckpt
from healthivert_tpu_torch.models import pix2pix
from healthivert_tpu_torch.utils import pth
from healthivert_tpu_torch.utils.weights import flax_discriminator_to_state_dict, flax_to_state_dict
from torch_port_fixtures import d_tree_to_reference_sd, g_tree_to_reference_sd, random_train_trees
from torch_port_fixtures import one_torch_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

CFG = pix2pix.Pix2PixConfig(ngf=4, ndf=8, image_size=64)
LR = 2e-4


def _batches(n=4):
    ds = SyntheticDataset(batch_size=2, seed=1, shape=(64, 64, 16), vert_ids=(19, 20),
                          vert_height=14, gap=8)
    return [{k: torch.from_numpy(np.asarray(v)) for k, v in ds.sample_batch().items()}
            for _ in range(n)]


def _tensors(state):
    """Every tensor of a TrainState, by name."""
    out = {"step": torch.tensor(state.step)}
    for net in ckpt.NETS:
        out.update({f"{net}.{k}": v for k, v in getattr(state, net).state_dict().items()})
    for o in ckpt.OPTS:
        for pid, st in getattr(state, o).state_dict()["state"].items():
            out.update({f"{o}.{pid}.{k}": v for k, v in st.items()})
    return out


def _assert_equal(a, b):
    ta, tb = _tensors(a), _tensors(b)
    assert ta.keys() == tb.keys()
    for k in ta:
        assert torch.equal(ta[k], tb[k]), k


@pytest.fixture(scope="module")
def two_steps(tmp_path_factory):
    """A state after 2 steps of 4 batches, saved as iter_4."""
    batches = _batches(4)
    state = pix2pix.init_state(CFG, seed=0, device="cpu")
    for b in batches[:2]:
        pix2pix.train_step(state, b, LR, CFG)
    run_dir = tmp_path_factory.mktemp("run")
    ckpt.save_checkpoint(state, run_dir, "iter_4")
    return state, run_dir, batches


def test_save_restore_gives_equal_tensors(two_steps):
    state, run_dir, _ = two_steps
    other = pix2pix.init_state(CFG, seed=5, device="cpu")
    key = "coarse_generator.conv1.conv.weight"
    assert not torch.equal(other.gen.state_dict()[key], state.gen.state_dict()[key])
    ckpt.restore_checkpoint(other, run_dir, "iter_4")
    assert other.step == 2
    _assert_equal(state, other)
    assert len(_tensors(state)) > 300


def test_resume_equals_an_uninterrupted_run(two_steps):
    """The saved run continued to step 4 against a fresh state (another
    seed) restored from its step-2 checkpoint and stepped twice."""
    saved, run_dir, batches = two_steps
    full = copy.deepcopy(saved)
    resumed = ckpt.restore_checkpoint(pix2pix.init_state(CFG, seed=9, device="cpu"),
                                      run_dir, "iter_4")
    for b in batches[2:]:
        _, losses_full = pix2pix.train_step(full, b, LR, CFG)
        _, losses = pix2pix.train_step(resumed, b, LR, CFG)
    assert resumed.step == full.step == 4
    _assert_equal(full, resumed)
    for k in losses_full:
        assert torch.equal(losses[k], losses_full[k]), k


def test_tags_atomic_write_and_generator_file(tmp_path, monkeypatch):
    opt = types.SimpleNamespace(epoch="latest", load_iter=0)
    assert ckpt.resolve_tag(opt) == "latest"
    opt.load_iter = 12
    assert ckpt.resolve_tag(opt) == "iter_12"
    opt.epoch, opt.load_iter = 3, 0
    assert ckpt.resolve_tag(opt) == "3"

    state = pix2pix.init_state(CFG, seed=0, device="cpu")
    path = ckpt.save_checkpoint(state, tmp_path, 7)
    assert path.endswith("7.pt") and ckpt.latest_exists(tmp_path, 7)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["7.pt"]

    def torn(obj, f):  # a crash halfway through the write
        open(f, "wb").write(b"half a checkpoint")
        raise OSError("disk full")

    monkeypatch.setattr(torch, "save", torn)
    state.step = 99
    with pytest.raises(OSError):
        ckpt.save_checkpoint(state, tmp_path, 7)
    monkeypatch.undo()
    assert ckpt.restore_checkpoint(pix2pix.init_state(CFG, seed=1, device="cpu"),
                                   tmp_path, 7).step == 0

    ckpt.save_generator(state, tmp_path)
    gen = pix2pix.build_generator(CFG)
    for tag in ("generator", 7):
        ckpt.restore_generator(gen, tmp_path, tag)
        for k, v in state.gen.state_dict().items():
            assert torch.equal(gen.state_dict()[k], v), k
    with pytest.raises(ValueError, match="no training state"):
        ckpt.restore_checkpoint(state, tmp_path, "generator")
    (tmp_path / "orbax_tag").mkdir()
    assert ckpt.orbax_exists(tmp_path, "orbax_tag")
    assert "--load_npz" in str(ckpt.orbax_error(tmp_path, "orbax_tag"))


@pytest.fixture(scope="module")
def trees():
    return random_train_trees(ngf=4, ndf=8, image_size=64, seed=3)


@pytest.mark.parametrize("nested", [False, True], ids=["flat", "state_dict"])
def test_reference_pth_matches_the_jax_reader(tmp_path, trees, nested):
    g_sd = g_tree_to_reference_sd(trees["g_params"], trees["g_sn"])
    torch.save({"state_dict": g_sd} if nested else g_sd, tmp_path / "5_net_G.pth")
    for i in (1, 2):  # D_3 missing: it keeps its initialisation
        torch.save(d_tree_to_reference_sd(trees[f"d{i}_params"], trees[f"d{i}_stats"]),
                   tmp_path / f"5_net_D_{i}.pth")
    state = pix2pix.init_state(CFG, seed=0, device="cpu")
    d3_before = {k: v.clone() for k, v in state.d3.state_dict().items()}
    ckpt.restore_full_pth(state, str(tmp_path / "5_net_G.pth"))

    other = random_train_trees(ngf=4, ndf=8, image_size=64, seed=8)  # JAX's starting trees
    p, sn, _ = jpth.load_generator_pth(str(tmp_path / "5_net_G.pth"), other["g_params"],
                                       other["g_sn"])
    want = flax_to_state_dict(p, sn)
    assert state.gen.state_dict().keys() == want.keys()
    for k, v in want.items():
        assert torch.equal(state.gen.state_dict()[k], v), k
    for i in (1, 2):
        p, st, _ = jpth.load_discriminator_pth(str(tmp_path / f"5_net_D_{i}.pth"),
                                               other[f"d{i}_params"], other[f"d{i}_stats"])
        want = flax_discriminator_to_state_dict(p, st)
        got = getattr(state, f"d{i}").state_dict()
        assert got.keys() == want.keys()
        for k, v in want.items():
            assert torch.equal(got[k], v), k
    for k, v in state.d3.state_dict().items():
        assert torch.equal(v, d3_before[k]), k


def test_bad_pth_raises(tmp_path, trees):
    g_sd = g_tree_to_reference_sd(trees["g_params"], trees["g_sn"])
    gen = pix2pix.build_generator(CFG)
    bad = dict(g_sd)
    k = next(k for k in bad if k.endswith("weight_orig"))
    bad[k] = bad[k][:, :1]
    torch.save(bad, tmp_path / "shape.pth")
    with pytest.raises(ValueError, match="shape mismatch"):
        pth.load_generator_pth(str(tmp_path / "shape.pth"), gen)
    torch.save({**g_sd, "coarse_generator.extra.bias": torch.zeros(3)}, tmp_path / "key.pth")
    with pytest.raises(KeyError, match="not in model"):
        pth.load_generator_pth(str(tmp_path / "key.pth"), gen)
    d_sd = d_tree_to_reference_sd(trees["d1_params"], trees["d1_stats"])
    torch.save({**d_sd, "model.40.weight": torch.zeros(1)}, tmp_path / "d.pth")
    with pytest.raises(KeyError, match="unexpected discriminator key"):
        pth.load_discriminator_pth(str(tmp_path / "d.pth"), pix2pix.build_discriminator(CFG))
