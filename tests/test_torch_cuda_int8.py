"""int8 inference on the card: the int8 product's card route (im2col of int8
views and `torch._int_mm`) against its plain version, and the int8
generator forward on the card against the port's CPU path.

Marked `cuda`: each test decides at run time whether there is a card and
skips with a reason otherwise. The file imports no JAX, so on a machine
without it the tests run with the repository's conftest left out:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_int8.py

Tolerances. The product sums int8 products exactly in int32 on both
routes: bit for bit. The forward, the bf16 one and the int8 one under one
gate (chip_smoke.CARD_CPU_TOL): cuDNN's bf16 convs, the elementwise
kernels and the bf16 attention kernel round here and there otherwise than
the CPU, the trained coarse CT head amplifies that, and under int8 an
activation near a boundary of the int8 grid then quantizes one step apart.
So each map's mean abs error <= 2.5e-2 (seen on an H100, batch 4: bf16
x_stage1 9.9e-3, int8 2.1e-2 dynamic, 1.1e-2 static), the binarised seg
maps apart on <= 1e-4 of the pixels (seen 2.3e-5 bf16, 5.7e-5 int8),
height fractions atol 1e-3 (seen 2e-4); the largest map error is not
gated (seen 0.115 bf16, 0.32 int8).
"""

import numpy as np
import pytest
import torch

from healthivert_tpu_torch.data.synthetic import SyntheticDataset
from healthivert_tpu_torch.engine.checkpoint import PRETRAINED_NPZ, load_generator
from healthivert_tpu_torch.models import pix2pix
from healthivert_tpu_torch.ops import int8_conv as ic
from healthivert_tpu_torch.ops.attention_cuda import attention_v2
from healthivert_tpu_torch.utils.device import float32_exact

pytestmark = pytest.mark.cuda

# (C, O, k, stride, padding, dilation, H) of the generator's int8 convs,
# plus a K and an O that are no multiples of 8 and a tiny M
CASES = {
    "stem_c3": (3, 16, 5, 1, 2, 1, 64), "stem_c4": (4, 16, 5, 1, 2, 1, 64),
    "stride2": (16, 32, 3, 2, 1, 1, 64), "dil2": (64, 64, 3, 1, 2, 2, 32),
    "dil16": (64, 64, 3, 1, 16, 16, 32), "c33": (33, 32, 3, 1, 1, 1, 64),
    "c128": (128, 64, 3, 1, 1, 1, 32), "c16_o8": (16, 8, 3, 1, 1, 1, 64),
    "k45_o12": (5, 12, 3, 1, 1, 1, 9), "tiny_m": (8, 8, 3, 1, 1, 1, 2),
}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    float32_exact()
    return torch.device("cuda")


@pytest.mark.parametrize("case", list(CASES))
def test_card_route_equals_plain(cuda_device, case):
    c, o, k, s, p, d, h = CASES[case]
    g = torch.Generator().manual_seed(len(case))
    qx = torch.randint(-127, 128, (3, c, h, h), generator=g, dtype=torch.int8)
    qw = torch.randint(-127, 128, (o, c, k, k), generator=g, dtype=torch.int8)
    qx = qx.to(cuda_device).contiguous(memory_format=torch.channels_last)
    qw = qw.to(cuda_device)
    before = ic.int8_conv2d.launches
    got = ic.int8_conv2d(qx, qw, s, p, d)
    torch.cuda.synchronize()
    assert ic.int8_conv2d.launches == before + 1
    want = ic.int8_conv2d_reference(qx, qw, s, p, d)
    assert got.dtype == torch.int32 and got.is_cuda and torch.equal(got, want)


def test_card_route_chunks(cuda_device, monkeypatch):
    g = torch.Generator().manual_seed(0)
    qx = torch.randint(-127, 128, (5, 16, 32, 32), generator=g, dtype=torch.int8).to(cuda_device)
    qw = torch.randint(-127, 128, (16, 16, 3, 3), generator=g, dtype=torch.int8).to(cuda_device)
    monkeypatch.setattr(ic, "IM2COL_BYTES", 2 * 32 * 32 * 144)
    assert torch.equal(ic.int8_conv2d(qx, qw, 1, 1, 1), ic.int8_conv2d_reference(qx, qw, 1, 1, 1))


def test_wrapper_refuses_what_the_card_route_does_not_take(cuda_device):
    qx = torch.zeros((1, 8, 4, 4), dtype=torch.int8, device=cuda_device)
    qw = torch.zeros((8, 8, 3, 3), dtype=torch.int8, device=cuda_device)
    with pytest.raises(TypeError):
        ic.int8_conv2d(qx.float(), qw)
    with pytest.raises(ValueError):
        ic.int8_conv2d(qx, qw.cpu())


@pytest.mark.parametrize("mode", ["bf16", "int8_dynamic", "int8_static"])
def test_forward_card_equals_cpu(cuda_device, mode):
    dtype = "bfloat16" if mode == "bf16" else "int8"
    cfg = pix2pix.Pix2PixConfig(ngf=16, image_size=256, compute_dtype=dtype)
    batch = SyntheticDataset(batch_size=4, seed=0, n_volumes=2).sample_batch()
    outs = {}
    quant = None
    for dev in ("cpu", cuda_device):
        gen = load_generator(PRETRAINED_NPZ, cfg, device=dev)
        tb = {k: torch.from_numpy(np.asarray(v)).to(dev) for k, v in batch.items()}
        if mode == "int8_static" and quant is None:
            quant = pix2pix.calibrate_int8(gen, [tb], cfg, percentile=99.5)
        a0, c0 = attention_v2.tc_launches, ic.int8_conv2d.launches
        with torch.no_grad():
            outs[str(dev)] = pix2pix.generator_forward(gen, tb, cfg, g_quant=quant)
        if dev != "cpu":
            torch.cuda.synchronize()
            assert attention_v2.tc_launches == a0 + 1
            assert ic.int8_conv2d.launches == c0 + (43 if dtype == "int8" else 0)
    got, want = outs["cuda"], outs["cpu"]
    for name in ("coarse_seg", "fine_seg", "x_stage1", "x_stage2"):
        g, w = getattr(got["gen"], name).float().cpu(), getattr(want["gen"], name).float()
        assert bool(torch.isfinite(g).all())
        assert float((g - w).abs().mean()) <= 2.5e-2, name
        if "seg" in name:
            assert float(((g > 0.5) != (w > 0.5)).float().mean()) <= 1e-4, name
    for name in ("pred1_h", "pred2_h"):
        np.testing.assert_allclose(getattr(got["gen"], name).cpu().numpy(),
                                   getattr(want["gen"], name).numpy(), atol=1e-3)
