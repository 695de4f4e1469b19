"""The v1 patch attention's bf16 tensor-core route, on the CPU.

The route (csrc/attention_tc_v1.cu) runs only on the card. This file holds
on the CPU what it adds to the forward's tensor-core pieces, which
tests/test_torch_attention_tc.py holds:

- Layout. The wrapper zero-pads K and RC to multiples of 64
  (`v1_tc_operands`); the kernels view fpat and wnorm as feature maps
  (B, hd, wd, Kp) and raw as (B, hd, wd, RCp), read them through the
  forward's 5-D tensor maps (one phase) in the padded position order
  (`tc_geometry`), and read probs^T through the forward's plane maps.
  `tma_box` emulates a TMA box load in numpy (out-of-bounds elements zero),
  and the score and paste GEMMs, tile by tile and K block by K block with
  their epilogues, give the plain version's s and vals at 6 x 10 (K = 180
  padded to 192, phantom columns 10-15), 32 x 32, and 3 x 70 (a 128-wide
  position order, RC = 32 padded to 64).
- Pad then cut. Zero channels add nothing: the plain version on the padded
  operands, cut back to RC, gives the unpadded result.
- Rounding. The route splits probs into hi + lo bf16 for the paste and
  rounds vals once to bf16. At 1 x 32 x 32, K = 576, RC = 1024 (the
  generator's shapes), soft attention and bf16 patch tensors, that stays
  within the bf16 gate (1e-3 + 1.6e-2 |vals|, two bf16 ulps) of the JAX
  package's `attention_scores_paste(interpret=True)` in float32, as
  tests/test_torch_attention_v1.py runs it.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import healthivert_tpu.ops.attention_pallas as ap
from healthivert_tpu_torch.ops import attention_cuda as ac
from healthivert_tpu_torch.ops.contextual_attention import fuse_scores

BK = BM = 64  # a tile's channels and positions (csrc/attention_tc.cuh)


def tma_box(data, dims, box, coords):
    """A TMA tiled box load (element strides 1), in numpy. data holds the
    tensor outermost first (its shape is dims reversed); box and coords are
    innermost first. Elements outside [0, dims[i]) are zero. Returns the
    box outermost first."""
    assert data.shape == tuple(reversed(dims))
    idx, ok = [], []
    for d, b, c in zip(dims, box, coords):
        at = c + np.arange(b)
        idx.append(np.clip(at, 0, d - 1))
        ok.append(((at >= 0) & (at < d)).astype(np.int8))
    mask = functools.reduce(np.multiply, np.ix_(*ok[::-1])) > 0
    return np.where(mask, data[np.ix_(*idx[::-1])], 0.0)


def feature_map(x, hd, wd, positions):
    """`feature_map(.., phases=1, positions)` of
    csrc/attention_tc_kernels.cuh over a (B, hd * wd, Cp) operand: the
    data, dims and box, innermost first."""
    bs, _, cp = x.shape
    wdp, _ = ac.tc_geometry(hd, wd)
    w = min(wdp, positions)
    return x.reshape(bs, 1, hd, wd, cp), (cp, wd, hd, 1, bs), (BK, w, positions // w, 1, 1)


def plane_map(x, hd, wd):
    """`plane_map` over a (B, hd * wd, kp) scratch plane."""
    bs, _, kp = x.shape
    wdp, _ = ac.tc_geometry(hd, wd)
    w = min(wdp, BM)
    return x.reshape(bs, hd, wd, kp), (kp, wd, hd, bs), (BK, w, BM // w, 1)


def real(q, hd, wd):
    """`Geom::real`: the grid index of padded position q, or -1."""
    wdp, _ = ac.tc_geometry(hd, wd)
    i, j = q // wdp, q % wdp
    return np.where((i < hd) & (j < wd), i * wd + j, -1)


def emulate_score(fpat_p, wnorm_p, hd, wd):
    """v1_gemm<kV1Score>: (64, 128) tiles of s over Kp / 64 chunks, written
    at the real (l, p); everything else stays NaN."""
    bs, num_l, kp_ch = fpat_p.shape
    wdp, _ = ac.tc_geometry(hd, wd)
    q = hd * wdp
    ma, mb = feature_map(wnorm_p, hd, wd, BM), feature_map(fpat_p, hd, wd, 128)
    s = np.full((bs, num_l, num_l), np.nan)
    for b in range(bs):
        for m0 in range(0, q, BM):
            for n0 in range(0, q, 128):
                acc = np.zeros((BM, 128))
                for k0 in range(0, kp_ch, BK):
                    a = tma_box(*ma, (k0, m0 % wdp, m0 // wdp, 0, b)).reshape(BM, BK)
                    bt = tma_box(*mb, (k0, n0 % wdp, n0 // wdp, 0, b)).reshape(128, BK)
                    acc += a @ bt.T
                ls, ps = real(m0 + np.arange(BM), hd, wd), real(n0 + np.arange(128), hd, wd)
                rows, cols = np.nonzero((ls[:, None] >= 0) & (ps[None, :] >= 0))
                s[b, ls[rows], ps[cols]] = acc[rows, cols]
    return s


def sweep_planes(probs, hd, wd):
    """What fuse_softmax_tc_kernel writes for the paste: probs^T (B, P, kp)
    in hi and lo bf16, row p holding probs[l, p] at l's padded position,
    zero at phantoms."""
    _, kp = ac.tc_geometry(hd, wd)
    ls = real(np.arange(kp), hd, wd)
    pt = torch.zeros(probs.shape[0], probs.shape[2], kp)
    pt[:, :, ls >= 0] = probs.transpose(1, 2)[:, :, ls[ls >= 0]]
    hi = pt.to(torch.bfloat16)
    return hi, (pt - hi.float()).to(torch.bfloat16)


def emulate_paste(pt_hi, pt_lo, raw_p, hd, wd, num_r):
    """v1_gemm<kV1Paste>: (64 positions, 64 columns) tiles of vals over kp
    / 64 K blocks, two A products (hi, lo) a block, B MN-major; written at
    the real p and c < RC; everything else stays NaN."""
    bs, num_l, rcp = raw_p.shape
    wdp, kp = ac.tc_geometry(hd, wd)
    a_hi, a_lo = (plane_map(p.double().numpy(), hd, wd) for p in (pt_hi, pt_lo))
    mb = feature_map(raw_p, hd, wd, BM)
    vals = np.full((bs, num_l, num_r), np.nan)
    for b in range(bs):
        for m0 in range(0, hd * wdp, BM):
            for c0 in range(0, rcp, 64):
                acc = np.zeros((BM, 64))
                for k0 in range(0, kp, BK):
                    at = (k0, m0 % wdp, m0 // wdp, b)
                    a = tma_box(*a_hi, at).reshape(BM, BK) + tma_box(*a_lo, at).reshape(BM, BK)
                    bt = tma_box(*mb, (c0, k0 % wdp, k0 // wdp, 0, b)).reshape(BK, 64)
                    acc += a @ bt
                ps, cs = real(m0 + np.arange(BM), hd, wd), c0 + np.arange(64)
                rows, cols = np.nonzero((ps[:, None] >= 0) & (cs[None, :] < num_r))
                vals[b, ps[rows], cs[cols]] = acc[rows, cols]
    return vals


def _patches(b, hd, wd, c, seed, dtype=torch.float32):
    """v1 patch tensors from seeded feature maps (fd scaled by 0.05: soft
    attention) and a gate with a hole band at the bottom."""
    rng = np.random.default_rng(seed)
    t = lambda *shape, k=1.0: torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32) * k).to(dtype)
    fd, bd, b_full = t(b, hd, wd, c, k=0.05), t(b, hd, wd, c), t(b, 2 * hd, 2 * wd, c)
    g = torch.ones(b, hd, wd)
    g[:, hd - hd // 3:] = 0.0
    return (*ac.v1_patches(fd, bd, b_full), g.reshape(b, -1))


def _probs(fpat, wnorm, mm, wd):
    s = torch.einsum("blk,bpk->blp", wnorm.float(), fpat.float())
    g = mm[:, :, None]
    return torch.softmax(fuse_scores(s, wd) * g * 10.0, dim=1) * g


@pytest.mark.parametrize("hd,wd,c", [(6, 10, 20), (32, 32, 8), (3, 70, 2)])
def test_tensor_map_emulation_gives_the_plain_scores_and_values(hd, wd, c):
    fpat, wnorm, raw, mm = _patches(2, hd, wd, c, seed=1)
    fpat_p, wnorm_p, raw_p = ac.v1_tc_operands(fpat, wnorm, raw)
    assert fpat_p.shape[-1] % 64 == 0 and raw_p.shape[-1] % 64 == 0
    s = emulate_score(fpat_p.double().numpy(), wnorm_p.double().numpy(), hd, wd)
    want_s = torch.einsum("blk,bpk->blp", wnorm.double(), fpat.double()).numpy()
    assert not np.isnan(s).any()  # every (l, p) written
    np.testing.assert_allclose(s, want_s, rtol=0, atol=1e-12)

    probs = _probs(fpat, wnorm, mm, wd)
    pt_hi, pt_lo = sweep_planes(probs, hd, wd)
    vals = emulate_paste(pt_hi, pt_lo, raw_p.double().numpy(), hd, wd, raw.shape[-1])
    split = (pt_hi.double() + pt_lo.double())[:, :, real(np.arange(pt_hi.shape[-1]), hd, wd) >= 0]
    want = torch.einsum("bpl,blr->bpr", split, raw.double()).numpy()
    assert not np.isnan(vals).any()
    np.testing.assert_allclose(vals, want, rtol=0, atol=1e-10)
    # and the route's arithmetic is the plain version's, up to the split
    # (|probs - hi - lo| <= 2^-17 probs, and a column of probs sums to at
    # most 1) and float32 sums
    ref = ac.attention_scores_paste_reference(fpat, wnorm, raw, mm, hd, wd, 10.0)
    atol = 2.0**-17 * float(raw.abs().max()) + 1e-6
    np.testing.assert_allclose(vals, ref.double().numpy(), rtol=0, atol=atol)


@pytest.mark.parametrize("hd,wd,c", [(6, 10, 20), (8, 8, 2)])
def test_pad_then_cut_gives_the_unpadded_result(hd, wd, c):
    """C = 20: K = 180 pads to 192 (its 360-byte rows are no multiple of 16
    bytes), RC = 320 needs no pad; C = 2: K = 18 and RC = 32 both pad."""
    fpat, wnorm, raw, mm = _patches(2, hd, wd, c, seed=2)
    padded = ac.v1_tc_operands(fpat, wnorm, raw)
    assert [t.shape[-1] for t in padded] == [-(-9 * c // 64) * 64] * 2 + [-(-16 * c // 64) * 64]
    for t, p in zip((fpat, wnorm, raw), padded):
        assert torch.equal(p[..., :t.shape[-1]], t) and not p[..., t.shape[-1]:].any()
    want = ac.attention_scores_paste_reference(fpat, wnorm, raw, mm, hd, wd, 10.0)
    got = ac.attention_scores_paste_reference(*padded, mm, hd, wd, 10.0)
    torch.testing.assert_close(got[..., :raw.shape[-1]], want, rtol=1e-6, atol=1e-6)
    assert not got[..., raw.shape[-1]:].any()


def test_operands_at_the_generators_shapes_are_not_copied():
    fpat, wnorm, raw, _ = _patches(1, 2, 2, 64, seed=3)
    assert (fpat.shape[-1], raw.shape[-1]) == (576, 1024)
    assert all(p is t for p, t in zip(ac.v1_tc_operands(fpat, wnorm, raw), (fpat, wnorm, raw)))


def test_split_stays_within_the_bf16_gate_of_jax():
    fpat, wnorm, raw, mm = _patches(1, 32, 32, 64, seed=4, dtype=torch.bfloat16)
    assert (fpat.shape[-1], raw.shape[-1]) == (576, 1024)
    want = np.asarray(ap.attention_scores_paste(
        *(jnp.asarray(t.float().numpy()) for t in (fpat, wnorm, raw)), jnp.asarray(mm.numpy()),
        32, 32, 10.0, interpret=True))
    want = torch.from_numpy(want.copy())
    probs = _probs(fpat, wnorm, mm, 32)
    hi = probs.to(torch.bfloat16)
    split = hi.float() + (probs - hi.float()).to(torch.bfloat16).float()
    got = torch.einsum("blp,blr->bpr", split, raw.float()).to(torch.bfloat16).float()
    excess = (got - want).abs() - (1e-3 + 1.6e-2 * want.abs())
    assert float(excess.max()) <= 0.0, float((got - want).abs().max())
    assert float(want.abs().max()) > 0.1  # the comparison is not of zeros
    assert float(probs.amax(dim=1).min()) < 0.9  # soft attention
