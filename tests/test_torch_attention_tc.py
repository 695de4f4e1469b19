"""The bf16 tensor-core route of the contextual attention, on the CPU.

The route (csrc/attention_tc.cu) runs only on the card. Its arithmetic is
the plain version's with two changes, and this file holds both on the CPU:

- Precision budget. The route splits each float32 (L, P) operand of a
  tensor-core product (probs in the paste and in db_full, ds0 in the score
  adjoints) into hi + lo bf16 halves and rounds its outputs to bf16; fd,
  bd, b_full and dy are bf16 already. `rounded_forward` and
  `rounded_backward` below are the plain versions with exactly those
  roundings. At 1 x 32 x 32 x 64, soft attention, bf16-valued inputs, they
  must stay within the bf16 gates of tests/test_torch_cuda_kernel.py
  against the JAX package in float32 (`attention_v2` and `attention_v2_bwd`
  in interpret mode, as tests/test_torch_attention.py runs them): y within
  1e-3 + 1.6e-2 |y| (two bf16 ulps); each gradient within two bf16 ulps
  plus 1e-4 of its largest entry.
- Layouts. The wrapper zero-pads channels to a multiple of 64, splits
  b_full and dy into their 2 x 2 phase planes, and sizes the kernels'
  scratch planes, whose rows hold positions in a padded order
  (`tc_geometry`). Those helpers are exact, and padding then cutting gives
  the plain result exactly (integer-valued inputs, so that no sum depends
  on its order).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import healthivert_tpu.ops.attention_pallas as ap
from healthivert_tpu_torch.ops import attention_cuda as ac
from healthivert_tpu_torch.ops.contextual_attention import (
    _fold_overlap_add,
    extract_patches,
    fuse_adjoint,
    patches_adjoint,
)

HD = WD = 32
C = 64


def split_bf16(x):
    """The route's split of a float32 operand (`split` in
    csrc/attention_tc.cu): hi = bf16(x), lo = bf16(x - hi)."""
    hi = x.to(torch.bfloat16)
    return hi, (x - hi.float()).to(torch.bfloat16)


def split_sum(x):
    """x as the tensor cores see it after split_bf16: hi + lo in float32."""
    hi, lo = split_bf16(x)
    return hi.float() + lo.float()


def one_rounding(x):
    return x.to(torch.bfloat16).float()


def rounded_forward(fd, bd, b_full, mm, rounding):
    """y of `attention_v2_reference` in float32, with the paste's probs
    rounded by `rounding`."""
    _, _, probs, _ = ac.attention_v2_reference(fd, bd, b_full, mm, HD, WD, 10.0, True)
    bs, c = fd.shape[0], fd.shape[-1]
    raw = extract_patches(b_full.float(), 4, 2).reshape(bs, HD * WD, -1)
    vals = torch.einsum("blp,blk->bpk", rounding(probs), raw).reshape(bs, HD, WD, 4, 4, c)
    return _fold_overlap_add(vals, 2 * HD, 2 * WD, 2, 4)


def rounded_backward(fd, bd, b_full, dy, probs, s, nrm_raw, mm, rounding):
    """(dfd, dbd, db_full) of `attention_v2_bwd_reference` in float32, with
    probs in the db_full product and ds0 in the score adjoints rounded by
    `rounding`."""
    bs, c, num_l = fd.shape[0], fd.shape[-1], HD * WD
    nrm = torch.clamp(nrm_raw, min=1e-4)
    g = mm[:, :, None]
    raw = extract_patches(b_full.float(), 4, 2).reshape(bs, num_l, -1)
    dv = extract_patches(dy.float(), 4, 2).reshape(bs, num_l, -1) / 4.0
    dprobs = torch.einsum("blr,bpr->blp", raw, dv)
    draw = torch.einsum("blp,bpr->blr", rounding(probs), dv)
    db_full = _fold_overlap_add(draw.reshape(bs, HD, WD, 4, 4, c), 2 * HD, 2 * WD, 2, 4) * 4.0
    dq = dprobs * g
    colsum = torch.sum(probs * dq, dim=1, keepdim=True)
    ds = fuse_adjoint(probs * (dq - colsum) * g * 10.0, WD)
    ds0 = ds / nrm
    dn = -torch.sum(ds * s, dim=2, keepdim=True) / nrm
    dnrm2 = torch.where(nrm_raw > 1e-4, dn * 0.5 / torch.clamp(nrm_raw, min=1e-12), 0.0)
    fpat = extract_patches(fd.float(), 3, 1).reshape(bs, num_l, -1)
    wpat = extract_patches(bd.float(), 3, 1).reshape(bs, num_l, -1)
    dfpat = torch.einsum("blp,blk->bpk", rounding(ds0), wpat)
    dwpat = torch.einsum("blp,bpk->blk", rounding(ds0), fpat) + 2.0 * wpat * dnrm2
    return (patches_adjoint(dfpat, HD, WD, c, 3), patches_adjoint(dwpat, HD, WD, c, 3), db_full)


def _bf16_valued(a):
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


@functools.lru_cache(maxsize=None)
def _case():
    """One sample, soft attention (fd scaled by 0.05), a hole band at the
    bottom (the sigma+ wrap reaches the last rows), bf16-valued inputs and
    cotangent, the JAX forward's residuals."""
    rng = np.random.default_rng(4)
    fd = _bf16_valued(rng.standard_normal((1, HD, WD, C)).astype(np.float32) * 0.05)
    bd = _bf16_valued(rng.standard_normal((1, HD, WD, C)).astype(np.float32))
    b_full = _bf16_valued(rng.standard_normal((1, 2 * HD, 2 * WD, C)).astype(np.float32))
    dy = _bf16_valued(rng.standard_normal((1, 2 * HD, 2 * WD, C)).astype(np.float32))
    g = np.ones((1, HD, WD), np.float32)
    g[:, HD - HD // 3 :] = 0.0
    mm = g.reshape(1, -1)
    j = tuple(map(jnp.asarray, (fd, bd, b_full, mm, dy)))
    y, s, probs, nrm = ap.attention_v2(j[0], j[1], j[2], j[3], HD, WD, 10.0, interpret=True,
                                       emit_residuals=True)
    grads = ap.attention_v2_bwd(j[0], j[1], j[2], j[4], probs, s, nrm, j[3], HD, WD, 10.0,
                                interpret=True)
    t = lambda a: torch.from_numpy(np.array(a))
    return {"inputs": tuple(map(t, (fd, bd, b_full, mm, dy))),
            "residuals": tuple(map(t, (probs, s, nrm))),
            "y": t(y), "grads": tuple(map(t, grads))}


def test_forward_split_stays_within_the_bf16_gate():
    case = _case()
    fd, bd, b_full, mm, _ = case["inputs"]
    y = rounded_forward(fd, bd, b_full, mm, split_sum)
    want = case["y"]
    y16 = y.to(torch.bfloat16).float()
    excess = (y16 - want).abs() - (1e-3 + 1.6e-2 * want.abs())
    assert float(excess.max()) <= 0.0, float((y16 - want).abs().max())
    # unrounded, the formulation is the plain version's; the split itself
    # costs far less than the output rounding
    y32 = ac.attention_v2_reference(fd, bd, b_full, mm, HD, WD, 10.0)
    assert float((rounded_forward(fd, bd, b_full, mm, lambda x: x) - y32).abs().max()) <= (
        1e-6 * float(want.abs().max()))
    assert float((y - y32).abs().max()) <= 1e-5 * float(want.abs().max())
    probs = case["residuals"][0]
    assert float(probs.amax(dim=1).min()) < 0.9  # soft attention


def test_one_bf16_rounding_would_break_the_gate():
    """Why the split: probs rounded once to bf16 for the paste put y
    outside the gate (by 1.57x of the allowance at this case)."""
    case = _case()
    fd, bd, b_full, mm, _ = case["inputs"]
    y = rounded_forward(fd, bd, b_full, mm, one_rounding)
    want = case["y"]
    excess = (y.to(torch.bfloat16).float() - want).abs() - (1e-3 + 1.6e-2 * want.abs())
    assert float(excess.max()) > 0.0


def test_backward_split_stays_within_the_bf16_gate():
    case = _case()
    fd, bd, b_full, mm, dy = case["inputs"]
    probs, s, nrm = case["residuals"]
    got = rounded_backward(fd, bd, b_full, dy, probs, s, nrm, mm, split_sum)
    exact = rounded_backward(fd, bd, b_full, dy, probs, s, nrm, mm, lambda x: x)
    plain = ac.attention_v2_bwd_reference(fd, bd, b_full, dy, probs, s, nrm, mm, HD, WD, 10.0)
    for name, g, e, p, w in zip(("dfd", "dbd", "db_full"), got, exact, plain, case["grads"]):
        # unrounded, the formulation is the plain version's
        assert float((e - p).abs().max()) <= 1e-6 * float(w.abs().max()), name
        g16 = g.to(torch.bfloat16).float()
        ulp = torch.ldexp(torch.ones_like(w), torch.frexp(w.abs()).exponent - 8)
        floor = 1e-4 * float(w.abs().max())
        assert bool(((g16 - w).abs() <= 2 * ulp + floor).all()), (
            name, float((g16 - w).abs().max()), float(w.abs().max()))
        assert float((g - p).abs().max()) <= 1e-5 * float(w.abs().max()), name


def test_split_bf16_halves():
    x = torch.from_numpy(np.random.default_rng(0).random(4096).astype(np.float32))
    hi, lo = split_bf16(x)
    assert hi.dtype == lo.dtype == torch.bfloat16
    assert float(((hi.float() + lo.float() - x).abs() / x.abs()).max()) <= 2.0 ** -17
    assert float(((hi.float() - x).abs() / x.abs()).max()) > 2.0 ** -12  # hi alone is coarser


@pytest.mark.parametrize("hd,wd", [(32, 32), (6, 10), (16, 16), (3, 70), (2, 2)])
def test_geometry_makes_tiles_rectangles(hd, wd):
    wdp, kp = ac.tc_geometry(hd, wd)
    assert wdp >= wd and kp % 64 == 0 and kp >= hd * wdp
    # 64 and 128 consecutive padded positions never straddle a row break
    # that the tensor map box cannot follow
    assert (64 % wdp == 0) if wdp <= 64 else (wdp % 128 == 0)
    if wd == 32:
        assert (wdp, kp) == (32, hd * 32)  # production: no padding


def test_phase_planes_and_channel_pad():
    rng = np.random.default_rng(2)
    hd, wd, c = 6, 10, 20
    x = torch.from_numpy(rng.standard_normal((2, 2 * hd, 2 * wd, c)).astype(np.float32))
    planes = ac.to_phase_planes(x, hd, wd, 64)
    assert planes.shape == (2, 4, hd, wd, 64)
    for r in range(2):
        for t in range(2):
            assert torch.equal(planes[:, 2 * r + t, ..., :c], x[:, r::2, t::2])
    assert float(planes[..., c:].abs().sum()) == 0.0
    assert torch.equal(ac.pad_channels(x, 64)[..., :c], x)
    assert ac.pad_channels(x, c) is x


@pytest.mark.parametrize("hd,wd,c", [(6, 10, 20), (8, 8, 4)])
def test_channel_pad_then_cut_gives_the_plain_result(hd, wd, c):
    """Zero channels add nothing: with integer-valued features every score
    and paste sum is exact, so the padded forward, cut back to c channels,
    equals the plain one bit for bit, residuals included. In the backward,
    with probs rounded to multiples of 1/8, db_full is exact too; dfd and
    dbd carry ds0, a quotient, and agree to float32 rounding."""
    rng = np.random.default_rng(3)
    ints = lambda *shape: torch.from_numpy(rng.integers(-3, 4, shape).astype(np.float32))
    fd, bd = ints(2, hd, wd, c), ints(2, hd, wd, c)
    b_full, dy = ints(2, 2 * hd, 2 * wd, c), ints(2, 2 * hd, 2 * wd, c)
    mm = torch.ones(2, hd * wd)
    mm[:, : wd] = 0.0
    pad = functools.partial(ac.pad_channels, cp=64)
    want = ac.attention_v2_reference(fd, bd, b_full, mm, hd, wd, 10.0, True)
    got = ac.attention_v2_reference(pad(fd), pad(bd), pad(b_full), mm, hd, wd, 10.0, True)
    assert torch.equal(got[0][..., :c], want[0]) and float(got[0][..., c:].abs().max()) == 0.0
    for g, w in zip(got[1:], want[1:]):
        assert torch.equal(g, w)
    _, s, probs, nrm = want
    # probs at the exact points of 1/8: every product and sum below is exact
    probs = torch.round(probs * 8) / 8
    grads = ac.attention_v2_bwd_reference(fd, bd, b_full, dy, probs, s, nrm, mm, hd, wd, 10.0)
    padded = ac.attention_v2_bwd_reference(pad(fd), pad(bd), pad(b_full), pad(dy), probs, s,
                                           nrm, mm, hd, wd, 10.0)
    assert torch.equal(padded[2][..., :c], grads[2])  # db_full: sums of exact products
    for g, w in zip(padded[:2], grads[:2]):
        torch.testing.assert_close(g[..., :c], w, rtol=1e-6, atol=1e-6)
        assert float(g[..., c:].abs().max()) == 0.0
