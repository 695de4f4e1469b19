"""The v1 patch attention's float32 tensor-core route (3xTF32), on the CPU.

The route (csrc/attention_tf32_v1.cu) runs only on the card. It is the
float32 forward's route (tests/test_torch_attention_tf32.py) with one tap
and no shift, on the v1 operands the bf16 route reads
(tests/test_torch_attention_v1_tc.py: K and RC zero-padded to 64, fpat and
wnorm viewed as feature maps). This file holds on the CPU what that adds:

- Rounding. Every float32 operand of the two GEMMs (wnorm and fpat for the
  score, probs^T and raw for the paste) goes to the tensor cores as big =
  tf32(x) and small = tf32(x - big), three products summed in float32
  (`product`). At 1 x 32 x 32, K = 576, RC = 1024 (the generator's
  shapes), soft attention, a bottom hole band and float32 patch tensors,
  that stays within the float32 gate the card holds v1 to (vals atol
  3e-4) of the JAX package's `attention_scores_paste(interpret=True)`
  (seen 6.2e-5; the plain version's own error is 6.3e-5, and the split
  moves vals by 4.3e-6 of their largest entry, 3.6).
- Layout. `emulate_score` and `emulate_paste` run the two GEMMs tile by
  tile in numpy through the float32 route's tensor maps: boxes of 32
  channels (128 bytes) with zeros out of bounds, one tap, no shift, the
  paste's B loaded as two 32-column boxes into the 128-byte swizzle and
  rewritten K-major and split by `PCOpTf32::transform`'s thread mapping.
  At 6 x 10 (K = 180 padded to 192), 32 x 32 and 3 x 70 (a 128-wide
  position order, RC = 32 padded to 64) they equal the split products of
  the plain formulation.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import healthivert_tpu.ops.attention_pallas as ap
from healthivert_tpu_torch.ops import attention_cuda as ac
from healthivert_tpu_torch.ops.contextual_attention import fuse_scores
from test_torch_attention_tf32 import (
    BM,
    DST,
    ROW,
    SRC,
    TensorMap,
    planes,
    product,
    real,
    split,
    split_np,
    swizzled,
)
from test_torch_attention_v1_tc import _patches, _probs


def tf32_v1(fpat, wnorm, raw, mm, wd, scale=10.0):
    """`attention_scores_paste_reference` with the score and the paste in
    3xTF32."""
    s = product("blk,bpk->blp", wnorm, fpat)
    g = mm[:, :, None]
    probs = torch.softmax(fuse_scores(s, wd) * g * scale, dim=1) * g
    return product("blp,blr->bpr", probs, raw)


def test_route_rounding_stays_within_the_float32_gate_of_jax():
    fpat, wnorm, raw, mm = _patches(1, 32, 32, 64, seed=4)
    assert (fpat.shape[-1], raw.shape[-1]) == (576, 1024)
    want = np.asarray(ap.attention_scores_paste(
        *(jnp.asarray(t.numpy()) for t in (fpat, wnorm, raw)), jnp.asarray(mm.numpy()),
        32, 32, 10.0, interpret=True))
    want = torch.from_numpy(want.copy())
    got = tf32_v1(fpat, wnorm, raw, mm, 32)
    err = float((got - want).abs().max())
    assert err <= 3e-4, err
    assert float(want.abs().max()) > 0.1  # the comparison is not of zeros
    assert float(_probs(fpat, wnorm, mm, 32).amax(dim=1).min()) < 0.9  # soft attention
    # and the split costs far less than the gate: against the plain version
    plain = ac.attention_scores_paste_reference(fpat, wnorm, raw, mm, 32, 32, 10.0)
    assert float((got - plain).abs().max()) <= 3e-5


def p64(spec, a, b):
    """The 3xTF32 products of einsum(spec, a, b) in float64."""
    (ab, as_), (bb, bs) = split(a.float()), split(b.float())
    return sum(torch.einsum(spec, x.double(), y.double()) for x, y in ((as_, bb), (ab, bs),
                                                                         (ab, bb)))


def emulate_score(fpat_p, wnorm_p, hd, wd):
    """v1_gemm_tf32<kV1Score>: (64, 128) tiles of s over Kp / 32 chunks, the
    split maps (Kp, wd, hd, 1, B) read at the tile's corner with no shift;
    written at the real (l, p), NaN elsewhere."""
    bs, num_l, kp_ch = fpat_p.shape
    wdp, _ = ac.tc_geometry(hd, wd)
    dims = (kp_ch, wd, hd, 1, bs)
    wa, wb = min(wdp, BM), min(wdp, 128)
    a_big, a_small = (TensorMap(m.reshape(bs, 1, hd, wd, kp_ch), dims, (ROW, wa, BM // wa, 1, 1))
                      for m in split_np(wnorm_p))
    b_big, b_small = (TensorMap(m.reshape(bs, 1, hd, wd, kp_ch), dims, (ROW, wb, 128 // wb, 1, 1))
                      for m in split_np(fpat_p))
    s = np.full((bs, num_l, num_l), np.nan)
    for b in range(bs):
        for m0 in range(0, hd * wdp, BM):
            for n0 in range(0, hd * wdp, 128):
                acc = np.zeros((BM, 128))
                for k0 in range(0, kp_ch, ROW):
                    at_a, at_b = (k0, m0 % wdp, m0 // wdp, 0, b), (k0, n0 % wdp, n0 // wdp, 0, b)
                    ab, as_ = a_big.load(at_a), a_small.load(at_a)
                    bb, bs_ = b_big.load(at_b), b_small.load(at_b)
                    acc += as_ @ bb.T + ab @ bs_.T + ab @ bb.T
                ls, ps = real(m0 + np.arange(BM), hd, wd), real(n0 + np.arange(128), hd, wd)
                rows, cols = np.nonzero((ls[:, None] >= 0) & (ps[None, :] >= 0))
                s[b, ls[rows], ps[cols]] = acc[rows, cols]
    return s


def emulate_paste(pl, raw_p, hd, wd, num_r):
    """v1_gemm_tf32<kV1Paste>: (64 positions, 64 columns) tiles of vals over
    kp / 32 K blocks. A: the split probs^T planes pl (B, P, kp) at the
    tile's rows; B: raw (RCp, wd, hd, 1, B) unsplit, its 32 K rows the
    block's positions, two 32-column boxes into the swizzled layout,
    rewritten K-major and split by the transform's mapping. Written at the
    real p and c < RC, NaN elsewhere."""
    bs, num_l, rcp = raw_p.shape
    wdp, kp = ac.tc_geometry(hd, wd)
    wa, wr = min(wdp, BM), min(wdp, ROW)
    a_big, a_small = (TensorMap(p.reshape(bs, hd, wd, kp), (kp, wd, hd, bs), (ROW, wa, BM // wa, 1))
                      for p in pl)
    b_map = TensorMap(raw_p.reshape(bs, 1, hd, wd, rcp).astype(np.float32), (rcp, wd, hd, 1, bs),
                      (ROW, wr, ROW // wr, 1, 1))
    r, e = np.meshgrid(np.arange(ROW), np.arange(ROW), indexing="ij")
    as_loaded = swizzled(r, e)  # where TMA puts row r, value e of a box
    n, k = np.meshgrid(np.arange(64), np.arange(ROW), indexing="ij")
    as_read = swizzled(n, k)  # where wgmma reads row n, entry k of a K-major tile
    vals = np.full((bs, num_l, num_r), np.nan)
    for b in range(bs):
        for m0 in range(0, hd * wdp, BM):
            for c0 in range(0, rcp, 64):
                acc = np.zeros((BM, 64))
                for k0 in range(0, kp, ROW):
                    at = (k0, m0 % wdp, m0 // wdp, b)
                    ab, as_ = a_big.load(at), a_small.load(at)
                    loaded = np.zeros(2 * 1024, np.float32)
                    for half in range(2):
                        loaded[half * 1024 + as_loaded] = b_map.load(
                            (c0 + ROW * half, k0 % wdp, k0 // wdp, 0, b))
                    big, small = np.zeros(64 * ROW), np.zeros(64 * ROW)
                    big[DST], small[DST] = split_np(loaded[SRC])
                    bb, bs_ = big[as_read].T, small[as_read].T  # (K, N)
                    acc += as_ @ bb + ab @ bs_ + ab @ bb
                ps, cs = real(m0 + np.arange(BM), hd, wd), c0 + np.arange(64)
                rows, cols = np.nonzero((ps[:, None] >= 0) & (cs[None, :] < num_r))
                vals[b, ps[rows], cs[cols]] = acc[rows, cols]
    return vals


@pytest.mark.parametrize("hd,wd,c", [(6, 10, 20), (32, 32, 8), (3, 70, 2)])
def test_tensor_map_emulation_gives_the_split_products(hd, wd, c):
    fpat, wnorm, raw, mm = _patches(2, hd, wd, c, seed=hd + wd)
    fpat_p, wnorm_p, raw_p = ac.v1_tc_operands(fpat, wnorm, raw)
    s = emulate_score(fpat_p.numpy(), wnorm_p.numpy(), hd, wd)
    assert not np.isnan(s).any()  # every (l, p) written
    np.testing.assert_allclose(s, p64("blk,bpk->blp", wnorm, fpat).numpy(), rtol=0, atol=1e-10)

    probs = _probs(fpat, wnorm, mm, wd)
    pt = probs.transpose(1, 2).contiguous()  # the paste's A rows: query positions p
    vals = emulate_paste(planes(pt.numpy(), hd, wd), raw_p.numpy(), hd, wd, raw.shape[-1])
    assert not np.isnan(vals).any()
    np.testing.assert_allclose(vals, p64("blp,blr->bpr", probs, raw).numpy(), rtol=0, atol=1e-10)
    # and within the split of the float32 plain version
    plain = ac.attention_scores_paste_reference(fpat, wnorm, raw, mm, hd, wd, 10.0)
    assert float(np.abs(vals - plain.double().numpy()).max()) <= 1e-5
