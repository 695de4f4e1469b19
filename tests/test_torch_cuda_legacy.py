"""The legacy networks on the card: the checks of chip_smoke.py's phase
legacy, smaller.

- one float32 train_step at net_d="seg" (ngf 16, ndf 16, 64 x 64, batch 2,
  lr 0) on the card against the port's CPU path from the same weights:
  the fine seg map binarised alike, every loss within rtol 1e-4, every
  gradient within 3e-3 of its network's largest, the discriminators'
  running statistics within atol 1e-5 (mean) and rtol 1e-4 (var); one
  launch of the attention forward and backward on the 3xTF32 route; and a
  bf16 seg step with one launch of each on the bf16 tensor-core route;
- UnetGenerator, ResnetGenerator and DualHeadUNet (ngf 16, 64 x 64, batch
  4) in training and eval mode, card against CPU within 1e-4 of the largest
  |output|.

Marked `cuda`: each test decides at run time whether there is a card and
skips with a reason otherwise. The file imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_legacy.py
"""

import numpy as np
import pytest
import torch

from healthivert_tpu_torch.data.synthetic import SyntheticDataset
from healthivert_tpu_torch.models import legacy, pix2pix
from healthivert_tpu_torch.ops.attention_cuda import attention_v2, attention_v2_bwd
from healthivert_tpu_torch.utils.device import float32_exact

pytestmark = pytest.mark.cuda

SMALL = dict(ngf=16, ndf=16, image_size=64, net_d="seg")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    float32_exact()
    return torch.device("cuda")


def _batch(dev):
    ds = SyntheticDataset(batch_size=2, seed=0, shape=(64, 64, 16), vert_ids=(19, 20),
                          vert_height=14, gap=8)
    return {k: torch.from_numpy(np.asarray(v)).to(dev) for k, v in ds.sample_batch().items()}


def _step(cfg, dev, lr=0.0):
    state = pix2pix.init_state(cfg, seed=0, device=dev)
    with torch.no_grad():
        seg = pix2pix.generator_forward(state.gen, _batch(dev), cfg)["gen"].fine_seg.cpu()
    state, losses = pix2pix.train_step(state, _batch(dev), lr, cfg)
    nets = {"g": state.gen, "d1": state.d1, "d2": state.d2, "d3": state.d3}
    grads = {n: {k: p.grad.detach().cpu() for k, p in m.named_parameters()}
             for n, m in nets.items()}
    stats = {f"{n}.{k}": v.detach().cpu() for n, m in nets.items() if n != "g"
             for k, v in m.state_dict().items() if ".running_" in k}
    return {k: float(v) for k, v in losses.items()}, grads, stats, seg


def test_seg_train_step_card_matches_cpu(cuda_device):
    cfg = pix2pix.Pix2PixConfig(**SMALL)
    counts = (attention_v2.tf32_launches, attention_v2_bwd.tf32_launches)
    got_l, got_g, got_s, got_seg = _step(cfg, cuda_device)
    torch.cuda.synchronize()
    # the forward of the seg map, then the step's forward and backward
    assert (attention_v2.tf32_launches - counts[0], attention_v2_bwd.tf32_launches - counts[1]) \
        == (2, 1)
    want_l, want_g, want_s, want_seg = _step(cfg, "cpu")
    assert torch.equal(got_seg > 0.5, want_seg > 0.5)
    for k, w in want_l.items():
        assert got_l[k] == pytest.approx(w, rel=1e-4), k
    for net, tensors in want_g.items():
        scale = max(float(w.abs().max()) for w in tensors.values())
        for k, w in tensors.items():
            assert float((got_g[net][k] - w).abs().max()) <= 3e-3 * scale, (net, k)
    for k, w in want_s.items():
        if k.endswith("mean"):
            torch.testing.assert_close(got_s[k], w, rtol=0, atol=1e-5, msg=k)
        else:
            torch.testing.assert_close(got_s[k], w, rtol=1e-4, atol=0, msg=k)


def test_bf16_seg_step_runs_on_the_tensor_core_route(cuda_device):
    cfg = pix2pix.Pix2PixConfig(**SMALL, compute_dtype="bfloat16")
    state = pix2pix.init_state(cfg, seed=0, device=cuda_device)
    counts = (attention_v2.tc_launches, attention_v2_bwd.tc_launches)
    state, losses = pix2pix.train_step(state, _batch(cuda_device), 2e-4, cfg)
    torch.cuda.synchronize()
    assert (attention_v2.tc_launches - counts[0], attention_v2_bwd.tc_launches - counts[1]) \
        == (1, 1)
    assert all(np.isfinite(float(v)) for v in losses.values())
    assert pix2pix._d_logits(state.d1, torch.zeros(2, 64, 64, 1, dtype=torch.bfloat16,
                                                   device=cuda_device)).dtype == torch.float32


@pytest.mark.parametrize("name", ["unet", "resnet", "dualhead"])
def test_legacy_generators_card_match_cpu(cuda_device, name):
    make = {"unet": lambda: legacy.UnetGenerator(1, 1, 6, 16),
            "resnet": lambda: legacy.ResnetGenerator(1, 1, 16, 3),
            "dualhead": lambda: legacy.DualHeadUNet(1, 1, 5, 16)}[name]
    cpu = make().init_weights(torch.Generator().manual_seed(0))
    card = make()
    card.load_state_dict(cpu.state_dict())
    card.to(cuda_device)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((4, 64, 64, 1))
                         .astype(np.float32))
    for mode in (True, False):
        cpu.train(mode)
        card.train(mode)
        with torch.no_grad():
            want, got = cpu(x), card(x.to(cuda_device))
        want = want if isinstance(want, tuple) else (want,)
        got = got if isinstance(got, tuple) else (got,)
        scale = max(float(w.abs().max()) for w in want)
        for g, w in zip(got, want):
            assert float((g.cpu() - w).abs().max()) <= 1e-4 * scale, (name, mode)
