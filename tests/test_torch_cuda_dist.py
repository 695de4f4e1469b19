"""Multi-GPU on one card: the checks of chip_smoke.py's phase dist, smaller.

- synthesize_volumes sharded over make_mesh("data:2", [cuda:0, cuda:0])
  at batch 16 bit-equal to the unsharded call at batch 8 (each shard the
  shape of an unsharded dispatch), one tensor-core attention launch a
  dispatch;
- run_training on the float32 recipe cut to 64 x 64, ndf 16, global batch
  8: two ranks on cuda:0 over gloo (NCCL refuses two ranks on one card)
  against one process, 2 steps: the ranks bit-equal, one float32-route
  forward and backward launch a step on each, the losses within rtol 1e-4,
  the first step's gradients (from one state in both runs) within 3e-3 of
  each network's largest, the parameters within the smoke's gate
  (chip_smoke.SUM_RTOL: every element within 2.2 lr a step, each network's
  sum of |w| within rtol 1e-5).

Marked `cuda`: each test decides at run time whether there is a card and
skips with a reason otherwise. The file imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_dist.py
"""

import numpy as np
import pytest
import torch

from healthivert_tpu_torch.data.synthetic import make_spine_volume
from healthivert_tpu_torch.engine import infer3d
from healthivert_tpu_torch.engine.checkpoint import PRETRAINED_NPZ, load_generator
from healthivert_tpu_torch.models.pix2pix import Pix2PixConfig
from healthivert_tpu_torch.ops.attention_cuda import attention_v2
from healthivert_tpu_torch.parallel.mesh import make_mesh
from healthivert_tpu_torch.utils.device import float32_exact
from torch_dist_worker import Ranks, run_training_first_grads

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    float32_exact()
    return torch.device("cuda")


def test_sharded_synthesis_on_one_card_is_bit_equal(cuda_device):
    cfg = Pix2PixConfig(ngf=16, image_size=256, compute_dtype="bfloat16")
    gen = load_generator(PRETRAINED_NPZ, cfg, device=cuda_device)
    ct, labels, cam = make_spine_volume(np.random.default_rng(0), shape=(256, 256, 16),
                                        fractured={20: 0.6})
    vols = [(ct, labels, 20, cam)]
    runs = []
    for batch, mesh in ((8, None), (16, make_mesh("data:2", devices=["cuda:0", "cuda:0"]))):
        attention_v2.tc_launches = 0
        infer3d._forward.dispatches = 0
        out = infer3d.synthesize_volumes(gen, cfg, vols, batch_size=batch, use_bf16=True,
                                         mesh=mesh, device=cuda_device)
        torch.cuda.synchronize()
        assert attention_v2.tc_launches == infer3d._forward.dispatches > 0
        runs.append(out[0])
    (a_ct, a_lb), (b_ct, b_lb) = runs
    np.testing.assert_array_equal(b_ct, a_ct)
    np.testing.assert_array_equal(b_lb, a_lb)
    assert (a_lb == 20).any()


def test_two_ranks_on_one_card_train_as_one_process(cuda_device, tmp_path):
    import chip_smoke
    from healthivert_tpu_torch.experiments.train_timing import read_recipe

    def recipe(name):
        opt = read_recipe()
        opt.compute_dtype, opt.synthetic_cache = "float32", 8
        opt.crop_size, opt.ndf, opt.batch_size = 64, 16, 8
        opt.checkpoints_dir, opt.name = str(tmp_path / name), name
        return opt

    opt = recipe("ranks")
    ranks = Ranks(tmp_path, [("train", "train", dict(opt=vars(opt), max_steps=2))],
                  device="cuda:0", backend="gloo", timeout=600)
    r0, r1 = (r["train"] for r in ranks.results())
    for net in r0["after"]:
        for k, v in r0["after"][net].items():
            assert torch.equal(v, r1["after"][net][k]), (net, k)
    for r in (r0, r1):
        assert [s["launches"] for s in r["steps"]] == [(1, 1), (2, 2)]
    losses = []
    state, _, want_g = run_training_first_grads(
        recipe("one"), max_steps=2, device=cuda_device,
        on_step=lambda step, l: losses.append({k: float(v) for k, v in l.items()}))
    for got, want in zip((s["losses"] for s in r0["steps"]), losses):
        for k, w in want.items():
            assert got[k] == pytest.approx(w, rel=chip_smoke.LOSS_RTOL), k
    nets = dict(zip(("g", "d1", "d2", "d3"), (state.gen, state.d1, state.d2, state.d3)))
    for net, w in chip_smoke.grads_within(r0["first_grads"], want_g).items():
        assert w["max_err_over_scale"] <= chip_smoke.GRAD_TOL, (net, w)
    params = {n: {k: p.detach().cpu() for k, p in m.named_parameters()} for n, m in nets.items()}
    chip_smoke.params_within(r0["after"], params, opt.lr, 2, "two ranks")
