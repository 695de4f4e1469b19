"""The CUDA attention kernels (forward, backward, the v1 patch attention
and the forward's stage ablation) against their plain PyTorch versions, on
the card. bf16 forward, backward, v1 and ablation run the tensor-core route
(csrc/attention_tc.cu, attention_tc_v1.cu, attention_tc_ablate.cu); their
float32 counterparts the tensor cores in 3xTF32 (csrc/attention_tf32.cu,
attention_tf32_v1.cu, attention_tf32_ablate.cu); the same tolerances hold
all.

Marked `cuda`: each test decides at run time whether there is a card and
skips with a reason otherwise. The file imports no JAX, so on a machine
without it the tests run with the repository's conftest left out:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernel.py

Tolerances. s, probs and nrm_raw are float32 in both versions and differ
only by the order of float32 sums and by the exp of two softmax
implementations: atol 2e-5 on s (seen 4.5e-8), atol 1e-4 on probs (seen
1.6e-5 on an H100), rtol 1e-5 on nrm_raw (seen 1.7e-7). y is returned in
the input dtype: float32 gets atol 3e-4 (seen 3.7e-5); bf16 gets
1e-3 + 1.6e-2 * |y|, two bf16 ulps, since both versions round float32
values that may straddle a rounding boundary (seen: one ulp).

Backward (dfd, dbd, db_full from the forward kernel's own residuals and a
random cotangent): both versions compute in float32 and differ by the order
of sums, so float32 gets |k - r| <= 1e-4 * max|r| (dfd reaches ~2e2 while
entries near zero come from cancelling sums; seen 3.3e-6 * max|r| on an
H100). bf16 outputs get two bf16 ulps of |r| plus 1e-4 * max|r| for
entries whose float32 values cancelled to near zero (seen: one ulp).

v1 (patch values from patch tensors): as y of the forward, atol 3e-4 in
float32 and two bf16 ulps in bf16. Ablation, every mode in both layouts:
`attn_ablate.ablate_within`, whose tolerance is stated beside its
constants (y's, widened for the unnormalised no_softmax outputs and for
paste_bf16's rounding straddles; no_paste and floor exactly zero).
"""

import numpy as np
import pytest
import torch

from healthivert_tpu_torch.experiments import attn_ablate
from healthivert_tpu_torch.ops import contextual_attention as ca
from healthivert_tpu_torch.ops.attention_cuda import (
    AttentionV2Function,
    attention_scores_paste,
    attention_scores_paste_reference,
    attention_v2,
    attention_v2_bwd,
    attention_v2_bwd_reference,
    attention_v2_reference,
    v1_patches,
)
from healthivert_tpu_torch.utils.device import float32_exact

pytestmark = pytest.mark.cuda

SHAPES = [(4, 32, 32, 64), (2, 16, 16, 4), (1, 6, 10, 20)]
BANDS = ["middle", "top", "bottom"]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    float32_exact()
    return torch.device("cuda")


def make_inputs(b, hd, wd, c, band, dtype, device, seed=0):
    """Features with soft attention (fd scaled down), and a gate whose hole
    band sits in the middle, top or bottom rows of the query grid."""
    rng = np.random.default_rng(seed)
    fd = rng.standard_normal((b, hd, wd, c)).astype(np.float32) * 0.05
    bd = rng.standard_normal((b, hd, wd, c)).astype(np.float32)
    b_full = rng.standard_normal((b, 2 * hd, 2 * wd, c)).astype(np.float32)
    g = np.ones((b, hd, wd), np.float32)
    rows = {"middle": slice(hd // 3, 2 * hd // 3), "top": slice(0, hd // 3),
            "bottom": slice(hd - hd // 3, hd)}[band]
    g[:, rows] = 0.0
    t = lambda a: torch.from_numpy(a).to(device=device, dtype=dtype)
    mm = torch.from_numpy(g.reshape(b, -1)).to(device)
    return t(fd), t(bd), t(b_full), mm


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("band", BANDS)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_kernel_matches_plain(cuda_device, shape, band, dtype):
    b, hd, wd, c = shape
    fd, bd, b_full, mm = make_inputs(b, hd, wd, c, band, dtype, cuda_device)
    y, s, probs, nrm = attention_v2(fd, bd, b_full, mm, hd, wd, 10.0, emit_residuals=True)
    torch.cuda.synchronize()
    y_r, s_r, p_r, n_r = attention_v2_reference(fd, bd, b_full, mm, hd, wd, 10.0, True)
    assert y.dtype == dtype and y.shape == (b, 2 * hd, 2 * wd, c)
    torch.testing.assert_close(s, s_r, rtol=0, atol=2e-5)
    torch.testing.assert_close(probs, p_r, rtol=0, atol=1e-4)
    torch.testing.assert_close(nrm, n_r, rtol=1e-5, atol=1e-6)
    if dtype == torch.float32:
        torch.testing.assert_close(y, y_r, rtol=0, atol=3e-4)
    else:
        torch.testing.assert_close(y.float(), y_r.float(), rtol=1.6e-2, atol=1e-3)
    # soft attention: the comparison is not of one-hot rows only
    assert float(p_r.amax(dim=1).min()) < 0.9


def test_dtype_picks_the_route(cuda_device):
    """bf16 launches the bf16 tensor-core route in both directions, float32
    the 3xTF32 route: `launches` counts both, `tc_launches` the first,
    `tf32_launches` the second."""
    counters = lambda: [getattr(fn, k) for fn in (attention_v2, attention_v2_bwd)
                        for k in ("launches", "tc_launches", "tf32_launches")]
    for dtype, tc in ((torch.bfloat16, 1), (torch.float32, 0)):
        fd, bd, b_full, mm = make_inputs(1, 8, 8, 4, "middle", dtype, cuda_device)
        ins = [t.clone().requires_grad_(True) for t in (fd, bd, b_full)]
        before = counters()
        AttentionV2Function.apply(*ins, mm, 8, 8, 10.0).float().square().sum().backward()
        torch.cuda.synchronize()
        assert [a - b for a, b in zip(counters(), before)] == [1, tc, 1 - tc] * 2, dtype


@pytest.mark.parametrize("direction", ["forward_B64", "backward_B32", "backward_B64", "v1_B64",
                                       "forward_B64_f32", "backward_B32_f32", "v1_B64_f32"])
def test_tensor_core_route_at_production_shapes(cuda_device, direction):
    """The main path's shapes (32 x 32, C = 64; the forward at the 3D
    driver's batch of 64, the backward at the recipe's 32, v1 at the
    ablation's 64 with K = 576, RC = 1024), bf16, at the tolerances above;
    the backward at 64, where B * L = 65536 rows pass the 65535 limit of a
    grid's y and z; and the float32 (3xTF32) forward at 64, backward at
    32 and v1 at 64, on the route each counts."""
    if direction == "v1_B64_f32":
        fd, bd, b_full, mm = make_inputs(64, 32, 32, 64, "middle", torch.float32, cuda_device)
        patches = v1_patches(fd, bd, b_full)
        before = attention_scores_paste.tf32_launches
        got = attention_scores_paste(*patches, mm, 32, 32, 10.0)
        torch.cuda.synchronize()
        assert attention_scores_paste.tf32_launches == before + 1
        want = attention_scores_paste_reference(*patches, mm, 32, 32, 10.0)
        torch.testing.assert_close(got, want, rtol=0, atol=3e-4)
    elif direction.endswith("_f32"):
        b = int(direction.split("_B")[1].split("_")[0])
        if direction.startswith("forward"):
            fd, bd, b_full, mm = make_inputs(b, 32, 32, 64, "middle", torch.float32, cuda_device)
            before = attention_v2.tf32_launches
            y, s, probs, nrm = attention_v2(fd, bd, b_full, mm, 32, 32, 10.0, emit_residuals=True)
            torch.cuda.synchronize()
            assert attention_v2.tf32_launches == before + 1
            y_r, s_r, p_r, n_r = attention_v2_reference(fd, bd, b_full, mm, 32, 32, 10.0, True)
            torch.testing.assert_close(s, s_r, rtol=0, atol=2e-5)
            torch.testing.assert_close(probs, p_r, rtol=0, atol=1e-4)
            torch.testing.assert_close(nrm, n_r, rtol=1e-5, atol=1e-6)
            torch.testing.assert_close(y, y_r, rtol=0, atol=3e-4)
            assert float(p_r.amax(dim=1).min()) < 0.9
        else:
            args = backward_case(b, 32, 32, 64, "middle", torch.float32, cuda_device)
            before = attention_v2_bwd.tf32_launches
            got = attention_v2_bwd(*args, 32, 32, 10.0)
            torch.cuda.synchronize()
            assert attention_v2_bwd.tf32_launches == before + 1
            want = attention_v2_bwd_reference(*args, 32, 32, 10.0)
            for name, g, w in zip(("dfd", "dbd", "db_full"), got, want):
                assert bwd_within(g, w, torch.float32), (
                    name, float((g - w).abs().max()), float(w.abs().max()))
    elif direction == "v1_B64":
        fd, bd, b_full, mm = make_inputs(64, 32, 32, 64, "middle", torch.bfloat16, cuda_device)
        patches = v1_patches(fd, bd, b_full)
        before = attention_scores_paste.tc_launches
        got = attention_scores_paste(*patches, mm, 32, 32, 10.0)
        torch.cuda.synchronize()
        assert attention_scores_paste.tc_launches == before + 1
        want = attention_scores_paste_reference(*patches, mm, 32, 32, 10.0)
        torch.testing.assert_close(got.float(), want.float(), rtol=1.6e-2, atol=1e-3)
    elif direction == "forward_B64":
        fd, bd, b_full, mm = make_inputs(64, 32, 32, 64, "middle", torch.bfloat16, cuda_device)
        y, s, probs, nrm = attention_v2(fd, bd, b_full, mm, 32, 32, 10.0, emit_residuals=True)
        torch.cuda.synchronize()
        y_r, s_r, p_r, n_r = attention_v2_reference(fd, bd, b_full, mm, 32, 32, 10.0, True)
        torch.testing.assert_close(s, s_r, rtol=0, atol=2e-5)
        torch.testing.assert_close(probs, p_r, rtol=0, atol=1e-4)
        torch.testing.assert_close(nrm, n_r, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(y.float(), y_r.float(), rtol=1.6e-2, atol=1e-3)
        assert float(p_r.amax(dim=1).min()) < 0.9
    else:
        b = int(direction.split("_B")[1])
        args = backward_case(b, 32, 32, 64, "middle", torch.bfloat16, cuda_device)
        got = attention_v2_bwd(*args, 32, 32, 10.0)
        torch.cuda.synchronize()
        want = attention_v2_bwd_reference(*args, 32, 32, 10.0)
        for name, g, w in zip(("dfd", "dbd", "db_full"), got, want):
            assert bwd_within(g, w, torch.bfloat16), (name, float((g.float() - w.float()).abs().max()))


def test_launch_counter_counts_kernel_launches_only(cuda_device):
    fd, bd, b_full, mm = make_inputs(1, 8, 8, 4, "middle", torch.float32, cuda_device)
    before = attention_v2.launches
    attention_v2(fd, bd, b_full, mm, 8, 8)
    attention_v2(fd.cpu(), bd.cpu(), b_full.cpu(), mm.cpu(), 8, 8)
    torch.cuda.synchronize()
    assert attention_v2.launches == before + 1


def test_wrapper_rejects_what_the_kernel_does_not_take(cuda_device):
    fd, bd, b_full, mm = make_inputs(1, 8, 8, 4, "middle", torch.float32, cuda_device)
    with pytest.raises(TypeError):
        attention_v2(fd.half(), bd.half(), b_full.half(), mm, 8, 8)
    with pytest.raises(ValueError):
        attention_v2(fd, bd.to(torch.bfloat16), b_full, mm, 8, 8)
    with pytest.raises(ValueError):
        attention_v2(fd.transpose(1, 2), bd, b_full, mm, 8, 8)
    with pytest.raises(ValueError):
        attention_v2(fd, bd, b_full[:, :8], mm, 8, 8)


def bwd_within(got, want, dtype):
    """The backward's tolerance (see the module docstring)."""
    got, want = got.float(), want.float()
    floor = 1e-4 * float(want.abs().max())
    if dtype == torch.float32:
        return float((got - want).abs().max()) <= floor
    ulp = torch.ldexp(torch.ones_like(want), torch.frexp(want.abs()).exponent - 8)
    return bool(((got - want).abs() <= 2 * ulp + floor).all())


def backward_case(b, hd, wd, c, band, dtype, device, seed=0):
    """Inputs, the forward kernel's residuals and a random cotangent."""
    fd, bd, b_full, mm = make_inputs(b, hd, wd, c, band, dtype, device, seed)
    _, s, probs, nrm = attention_v2(fd, bd, b_full, mm, hd, wd, 10.0, emit_residuals=True)
    rng = np.random.default_rng(seed + 1)
    dy = torch.from_numpy(rng.standard_normal((b, 2 * hd, 2 * wd, c)).astype(np.float32))
    return fd, bd, b_full, dy.to(device=device, dtype=dtype), probs, s, nrm, mm


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("band", BANDS)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_backward_kernel_matches_plain(cuda_device, shape, band, dtype):
    b, hd, wd, c = shape
    args = backward_case(b, hd, wd, c, band, dtype, cuda_device)
    got = attention_v2_bwd(*args, hd, wd, 10.0)
    torch.cuda.synchronize()
    want = attention_v2_bwd_reference(*args, hd, wd, 10.0)
    for name, g, w, like in zip(("dfd", "dbd", "db_full"), got, want, args[:3]):
        assert g.dtype == dtype and g.shape == like.shape, name
        assert bwd_within(g, w, dtype), (name, float((g.float() - w.float()).abs().max()),
                                         float(w.float().abs().max()))
    assert float(args[4].amax(dim=1).min()) < 0.9  # soft attention


def test_function_launches_one_kernel_each_way(cuda_device):
    fd, bd, b_full, mm = make_inputs(2, 8, 8, 4, "bottom", torch.float32, cuda_device)
    ins = [t.clone().requires_grad_(True) for t in (fd, bd, b_full)]
    before = (attention_v2.launches, attention_v2_bwd.launches)
    y = AttentionV2Function.apply(*ins, mm, 8, 8, 10.0)
    (y * y).sum().backward()
    torch.cuda.synchronize()
    assert (attention_v2.launches, attention_v2_bwd.launches) == (before[0] + 1, before[1] + 1)
    cpu = [t.detach().cpu().requires_grad_(True) for t in ins]
    y_cpu = AttentionV2Function.apply(*cpu, mm.cpu(), 8, 8, 10.0)
    (y_cpu * y_cpu).sum().backward()
    assert (attention_v2.launches, attention_v2_bwd.launches) == (before[0] + 1, before[1] + 1)
    for g, w in zip(ins, cpu):
        torch.testing.assert_close(g.grad.cpu(), w.grad, rtol=1e-4, atol=1e-4)


def test_backward_wrapper_rejects_what_the_kernel_does_not_take(cuda_device):
    args = list(backward_case(1, 8, 8, 4, "middle", torch.float32, cuda_device))

    def call(**repl):
        a = list(args)
        for i, v in repl.items():
            a[int(i[1:])] = v
        return attention_v2_bwd(*a, 8, 8)

    fd, dy, probs, nrm = args[0], args[3], args[4], args[6]
    with pytest.raises(TypeError):
        call(a0=fd.half(), a1=args[1].half(), a2=args[2].half(), a3=dy.half())
    with pytest.raises(ValueError):  # dy in another dtype than the inputs
        call(a3=dy.to(torch.bfloat16))
    with pytest.raises(ValueError):  # residual of the wrong shape
        call(a4=probs[:, :32])
    with pytest.raises(ValueError):  # residual in bf16
        call(a6=nrm.to(torch.bfloat16))
    with pytest.raises(ValueError):  # residual on another device
        call(a5=args[5].cpu())
    with pytest.raises(ValueError):  # non-contiguous cotangent
        call(a3=dy.transpose(1, 2).contiguous().transpose(1, 2))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("band", BANDS)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_v1_kernel_matches_plain(cuda_device, shape, band, dtype):
    b, hd, wd, c = shape
    fd, bd, b_full, mm = make_inputs(b, hd, wd, c, band, dtype, cuda_device)
    patches = v1_patches(fd, bd, b_full)
    counters = lambda: [getattr(attention_scores_paste, k)
                        for k in ("launches", "tc_launches", "tf32_launches")]
    before = counters()
    got = attention_scores_paste(*patches, mm, hd, wd, 10.0)
    torch.cuda.synchronize()
    # bf16 on the bf16 tensor-core route, float32 on the 3xTF32 route (K =
    # 180 padded to 192 at C = 20)
    tc = int(dtype == torch.bfloat16)
    assert [a - n for a, n in zip(counters(), before)] == [1, tc, 1 - tc]
    want = attention_scores_paste_reference(*patches, mm, hd, wd, 10.0)
    assert got.dtype == dtype and got.shape == (b, hd * wd, 16 * c)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=0, atol=3e-4)
    else:
        torch.testing.assert_close(got.float(), want.float(), rtol=1.6e-2, atol=1e-3)


def test_v1_tc_raises_where_the_route_cannot_go(cuda_device):
    """A bf16 v1 call whose operand TMA cannot read (two bytes off a
    16-byte boundary; K = 576 is not copied by the pad) raises and counts
    no launch; there is no other route to drop to."""
    fd, bd, b_full, mm = make_inputs(1, 8, 8, 64, "middle", torch.bfloat16, cuda_device)
    fpat, wnorm, raw = v1_patches(fd, bd, b_full)
    off = torch.empty(fpat.numel() + 1, dtype=fpat.dtype, device=fpat.device)[1:]
    off = off.view(fpat.shape).copy_(fpat)
    assert off.is_contiguous() and off.data_ptr() % 16 != 0
    before = (attention_scores_paste.launches, attention_scores_paste.tc_launches)
    with pytest.raises(RuntimeError, match="cuTensorMapEncodeTiled"):
        attention_scores_paste(off, wnorm, raw, mm, 8, 8)
    torch.cuda.synchronize()
    assert (attention_scores_paste.launches, attention_scores_paste.tc_launches) == before


@pytest.mark.parametrize("name", ["fd", "bd"])
def test_tf32_raises_on_a_misaligned_input(cuda_device, name):
    """A float32 forward whose fd or bd starts four bytes off a 16-byte
    boundary (C = 64, so the wrapper passes it on uncopied) raises before
    any launch and counts none: the split reads it four floats at a time,
    and a misaligned read would poison the context instead of raising."""
    inputs = dict(zip(("fd", "bd", "b_full", "mm"),
                      make_inputs(1, 8, 8, 64, "middle", torch.float32, cuda_device)))
    x = inputs[name]
    off = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)[1:]
    inputs[name] = off.view(x.shape).copy_(x)
    assert inputs[name].is_contiguous() and inputs[name].data_ptr() % 16 != 0
    before = (attention_v2.launches, attention_v2.tf32_launches)
    with pytest.raises(ValueError, match="16-byte"):
        attention_v2(*inputs.values(), 8, 8)
    torch.cuda.synchronize()
    assert (attention_v2.launches, attention_v2.tf32_launches) == before
    y = attention_v2(*{**inputs, name: x}.values(), 8, 8)  # the context is still usable
    torch.cuda.synchronize()
    assert torch.isfinite(y).all()


@pytest.mark.parametrize("name", ["fpat", "wnorm"])
def test_tf32_v1_raises_on_a_misaligned_input(cuda_device, name):
    """A float32 v1 call whose fpat or wnorm starts four bytes off a 16-byte
    boundary (K = 576, so the wrapper passes it on uncopied) raises before
    any launch and counts none: the split reads it four floats at a time;
    the context is still usable after it."""
    fd, bd, b_full, mm = make_inputs(1, 8, 8, 64, "middle", torch.float32, cuda_device)
    patches = dict(zip(("fpat", "wnorm", "raw"), v1_patches(fd, bd, b_full)))
    x = patches[name]
    off = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)[1:]
    patches[name] = off.view(x.shape).copy_(x)
    assert patches[name].is_contiguous() and patches[name].data_ptr() % 16 != 0
    before = (attention_scores_paste.launches, attention_scores_paste.tf32_launches)
    with pytest.raises(ValueError, match="16-byte"):
        attention_scores_paste(*patches.values(), mm, 8, 8)
    torch.cuda.synchronize()
    assert (attention_scores_paste.launches, attention_scores_paste.tf32_launches) == before
    vals = attention_scores_paste(*{**patches, name: x}.values(), mm, 8, 8)
    torch.cuda.synchronize()
    assert torch.isfinite(vals).all()


def test_offsets_keep_the_gradient(cuda_device):
    """contextual_attention with compute_offsets under grad: y has a
    grad_fn, y and the offsets equal the paths without offsets and without
    grad, and the gradient the path without offsets' (within the
    backward's tolerance), on both routes."""
    for dtype in (torch.float32, torch.bfloat16):
        f, b, _, _ = make_inputs(2, 16, 16, 8, "middle", dtype, cuda_device)
        mask = torch.zeros(2, 64, 64, 1, device=cuda_device)
        mask[:, 24:48] = 1.0
        with torch.no_grad():
            want_off = ca.contextual_attention(f, b, mask, compute_offsets=True).offsets
        leaves = [t.clone().requires_grad_(True) for t in (f, b)]
        out = ca.contextual_attention(*leaves, mask, compute_offsets=True)
        assert out.y.grad_fn is not None, dtype
        y = ca.contextual_attention(*leaves, mask).y
        assert torch.equal(out.y, y) and torch.equal(out.offsets, want_off), dtype
        cot = torch.randn(y.shape, generator=torch.Generator().manual_seed(0)).to(y)
        got = torch.autograd.grad((out.y.float() * cot).sum(), leaves)
        want = torch.autograd.grad((y.float() * cot).sum(), leaves)
        for g, w in zip(got, want):  # the bf16 backward sums its norm rows with atomics
            assert bwd_within(g, w, dtype), (dtype, float((g.float() - w.float()).abs().max()))


def test_bf16_gemm_launches_on_a_second_card(cuda_device):
    """The GEMMs' shared-memory attribute is set on each device: a bf16
    forward and v1 call on cuda:1 after one on cuda:0 launch and agree with
    their plain versions."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two NVIDIA GPUs: torch.cuda.device_count() < 2")
    for dev in (torch.device("cuda:0"), torch.device("cuda:1")):
        fd, bd, b_full, mm = make_inputs(2, 16, 16, 64, "bottom", torch.bfloat16, dev)
        y = attention_v2(fd, bd, b_full, mm, 16, 16)
        patches = v1_patches(fd, bd, b_full)
        vals = attention_scores_paste(*patches, mm, 16, 16)
        torch.cuda.synchronize(dev)
        y_r = attention_v2_reference(fd, bd, b_full, mm, 16, 16)
        v_r = attention_scores_paste_reference(*patches, mm, 16, 16)
        torch.testing.assert_close(y.float(), y_r.float(), rtol=1.6e-2, atol=1e-3)
        torch.testing.assert_close(vals.float(), v_r.float(), rtol=1.6e-2, atol=1e-3)


def test_v1_wrapper_rejects_what_the_kernel_does_not_take(cuda_device):
    fd, bd, b_full, mm = make_inputs(1, 8, 8, 4, "middle", torch.float32, cuda_device)
    fpat, wnorm, raw = v1_patches(fd, bd, b_full)
    with pytest.raises(TypeError):
        attention_scores_paste(fpat.half(), wnorm.half(), raw.half(), mm, 8, 8)
    with pytest.raises(ValueError):  # operands in two dtypes
        attention_scores_paste(fpat, wnorm.to(torch.bfloat16), raw, mm, 8, 8)
    with pytest.raises(ValueError):  # P != hd * wd
        attention_scores_paste(fpat, wnorm, raw, mm, 8, 4)
    with pytest.raises(ValueError):  # non-contiguous
        attention_scores_paste(fpat, wnorm, raw.transpose(1, 2).contiguous().transpose(1, 2),
                               mm, 8, 8)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("layout", attn_ablate.LAYOUTS)
@pytest.mark.parametrize("mode", attn_ablate.MODES)
@pytest.mark.parametrize("shape", [(2, 32, 32, 64), (1, 6, 10, 20), (1, 3, 70, 8)],
                         ids=lambda s: "x".join(map(str, s)))
def test_ablate_kernel_matches_plain(cuda_device, shape, mode, layout, dtype):
    """bf16 runs the bf16 tensor-core route, float32 the 3xTF32 route
    (channels padded to 64 at C = 20 and 8; 70 columns in a 128-wide
    position order), each counted on its own counter."""
    b, hd, wd, c = shape
    fd, bd, b_full, mm = make_inputs(b, hd, wd, c, "bottom", dtype, cuda_device)
    b_in = b_full if layout == "natural" else attn_ablate.to_phases(b_full, hd, wd)
    ab = attn_ablate.attention_v2_ablate
    before = (ab.tc_launches, ab.tf32_launches)
    got = ab(fd, bd, b_in, mm, hd, wd, 10.0, mode, layout)
    torch.cuda.synchronize()
    tc = int(dtype == torch.bfloat16)
    assert (ab.tc_launches, ab.tf32_launches) == (before[0] + tc, before[1] + 1 - tc)
    want = attn_ablate.ablate_layout_reference(fd, bd, b_in, mm, hd, wd, 10.0, mode, layout)
    assert got.dtype == dtype and got.shape == b_in.shape
    _, _, probs, _ = attention_v2_reference(fd, bd, b_full, mm, hd, wd, 10.0, True)
    pmax, rmax = float(probs.max()), float(b_full.float().abs().max())
    ok, err = attn_ablate.ablate_within(got, want, mode, pmax, rmax)
    assert ok, err


def test_ablate_entry_functions_count_their_launches(cuda_device):
    fd, bd, b_full, mm = make_inputs(1, 8, 8, 4, "top", torch.float32, cuda_device)
    bph = attn_ablate.to_phases(b_full, 8, 8)
    fns = (attn_ablate.run, attn_ablate.run_padded, attn_ablate.run_auto, attn_ablate.run_fold)
    before = [f.launches for f in fns] + [attn_ablate.attention_v2_ablate.tf32_launches]
    outs = [f(fd, bd, bph if f is attn_ablate.run_padded else b_full, mm, 8, 8) for f in fns]
    torch.cuda.synchronize()
    after = [f.launches for f in fns] + [attn_ablate.attention_v2_ablate.tf32_launches]
    assert [a - n for a, n in zip(after, before)] == [1, 1, 1, 1, 4]
    outs[1] = attn_ablate.from_phases(outs[1])
    for y in outs[1:]:  # one arithmetic in both layouts and ring depths: bit-equal
        assert torch.equal(y, outs[0])
    # the float32 ablation runs the float32 forward's 3xTF32 kernels: full
    # is attention_v2 bit for bit
    assert torch.equal(outs[0], attention_v2(fd, bd, b_full, mm, 8, 8))
    with pytest.raises(ValueError):  # b_full in the phase layout's place
        attn_ablate.run_padded(fd, bd, b_full, mm, 8, 8)


@pytest.mark.parametrize("mode", attn_ablate.MODES)
@pytest.mark.parametrize("shape", [(2, 32, 32, 64), (1, 6, 10, 20)],
                         ids=lambda s: "x".join(map(str, s)))
def test_ablate_tf32_entry_functions_are_bit_equal(cuda_device, shape, mode):
    """The float32 twin of the test below: the four entry functions launch
    the 3xTF32 route once each and count it; both layouts and both ring
    depths (run_auto at depth 1) give bit-equal outputs in every mode, and
    run(mode="full") is the float32 attention_v2 bit for bit."""
    b, hd, wd, c = shape
    fd, bd, b_full, mm = make_inputs(b, hd, wd, c, "middle", torch.float32, cuda_device)
    bph = attn_ablate.to_phases(b_full, hd, wd)
    fns = (attn_ablate.run, attn_ablate.run_padded, attn_ablate.run_auto, attn_ablate.run_fold)
    ab = attn_ablate.attention_v2_ablate
    before = [f.launches for f in fns] + [ab.tf32_launches, ab.tc_launches]
    outs = [f(fd, bd, bph if f is attn_ablate.run_padded else b_full, mm, hd, wd, mode=mode)
            for f in fns]
    torch.cuda.synchronize()
    after = [f.launches for f in fns] + [ab.tf32_launches, ab.tc_launches]
    assert [a - n for a, n in zip(after, before)] == [1, 1, 1, 1, 4, 0]
    outs[1] = attn_ablate.from_phases(outs[1])
    for name, y in zip(("run_padded", "run_auto", "run_fold"), outs[1:]):
        assert torch.equal(y, outs[0]), (name, float((y - outs[0]).abs().max()))
    if mode == "full":
        assert torch.equal(outs[0], attention_v2(fd, bd, b_full, mm, hd, wd))


@pytest.mark.parametrize("mode", attn_ablate.MODES)
@pytest.mark.parametrize("shape", [(2, 32, 32, 64), (1, 6, 10, 20)],
                         ids=lambda s: "x".join(map(str, s)))
def test_ablate_tc_entry_functions_are_bit_equal(cuda_device, shape, mode):
    """The bf16 twin of the test above: the four entry functions launch the
    tensor-core route once each and count it; the phase layout, the
    natural layout (b_full through the stride-2 tensor map) and the depth-1
    ring (run_auto) run the same products in the same order, so every mode's
    outputs are bit-equal; and run(mode="full") is attention_v2."""
    b, hd, wd, c = shape
    fd, bd, b_full, mm = make_inputs(b, hd, wd, c, "middle", torch.bfloat16, cuda_device)
    bph = attn_ablate.to_phases(b_full, hd, wd)
    fns = (attn_ablate.run, attn_ablate.run_padded, attn_ablate.run_auto, attn_ablate.run_fold)
    before = [f.launches for f in fns] + [attn_ablate.attention_v2_ablate.tc_launches]
    outs = [f(fd, bd, bph if f is attn_ablate.run_padded else b_full, mm, hd, wd, mode=mode)
            for f in fns]
    torch.cuda.synchronize()
    after = [f.launches for f in fns] + [attn_ablate.attention_v2_ablate.tc_launches]
    assert [a - n for a, n in zip(after, before)] == [1, 1, 1, 1, 4]
    outs[1] = attn_ablate.from_phases(outs[1])
    for name, y in zip(("run_padded", "run_auto", "run_fold"), outs[1:]):
        assert torch.equal(y, outs[0]), (name, float((y.float() - outs[0].float()).abs().max()))
    if mode == "full":
        assert torch.equal(outs[0], attention_v2(fd, bd, b_full, mm, hd, wd))


def test_ablate_tc_raises_where_the_route_cannot_go(cuda_device):
    """A launch the tensor-core route refuses raises and counts no launch;
    there is no other route to drop to. TMA reads from 16-byte aligned
    addresses only: bf16 b_full two bytes off (C = 64, so the wrapper passes
    it on uncopied) fails to make its tensor map, in the natural layout and
    the phase layout alike; the depth-1 ring has the phase layout only, on
    either route; and a float32 fd four bytes off, which the split would
    read four floats at a time, raises before any launch."""
    fd, bd, b_full, mm = make_inputs(1, 8, 8, 64, "middle", torch.bfloat16, cuda_device)
    ab = attn_ablate.attention_v2_ablate
    before = (ab.tc_launches, ab.tf32_launches, attn_ablate.run.launches)
    for layout in attn_ablate.LAYOUTS:
        b_in = b_full if layout == "natural" else attn_ablate.to_phases(b_full, 8, 8)
        off = torch.empty(b_in.numel() + 1, dtype=b_in.dtype, device=b_in.device)[1:]
        off = off.view(b_in.shape).copy_(b_in)
        assert off.is_contiguous() and off.data_ptr() % 16 != 0
        with pytest.raises(RuntimeError, match="cuTensorMapEncodeTiled"):
            ab(fd, bd, off, mm, 8, 8, 10.0, "full", layout)
    f32 = [t.float() for t in (fd, bd, b_full)]
    for args in ((fd, bd, b_full), f32):  # the depth-1 ring has the phase layout only
        with pytest.raises(RuntimeError):
            ab(*args, mm, 8, 8, 10.0, "full", "natural", attn_ablate.RING_SYNC)
    with pytest.raises(ValueError):  # no ring of depth 2 in bf16
        ab(fd, bd, b_full, mm, 8, 8, 10.0, "full", "natural", 2)
    with pytest.raises(ValueError):  # nor of depth 4 in float32
        ab(*f32, mm, 8, 8, 10.0, "full", "natural", 4)
    off = torch.empty(f32[0].numel() + 1, device=fd.device)[1:].view(f32[0].shape).copy_(f32[0])
    assert off.data_ptr() % 16 != 0
    with pytest.raises(ValueError, match="16-byte"):
        ab(off, *f32[1:], mm, 8, 8, 10.0, "full", "natural")
    torch.cuda.synchronize()
    assert (ab.tc_launches, ab.tf32_launches, attn_ablate.run.launches) == before
