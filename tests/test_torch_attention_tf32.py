"""The float32 tensor-core route of the contextual attention, on the CPU.

The route (csrc/attention_tf32.cu) runs only on the card. This file holds
on the CPU what it changes against the plain version:

- Rounding (3xTF32). Every float32 operand x of the six GEMMs goes to the
  tensor cores as big = tf32(x) and small = tf32(x - big), tf32 rounding
  to 10 mantissa bits to nearest with ties away from zero (cvt.rna), and
  each product as small big + big small + big big in float32.
  `tf32_forward` and `tf32_backward` are the plain versions with every GEMM
  so split. At 1 x 32 x 32 x 64, soft attention, a bottom hole band and
  float32 (not bf16-valued) inputs they must stay within the float32 gates
  of tests/test_torch_cuda_kernel.py against the JAX package
  (`attention_v2` and `attention_v2_bwd` in interpret mode): s atol 2e-5,
  probs 1e-4, y 3e-4, each gradient 1e-4 of its largest entry. One TF32
  rounding of the score operands breaks the score gate.
- Layout. The (L, P) GEMMs read split feature maps in boxes of 32 channels;
  the (P, C) GEMMs read their B operand (a feature map, positions as K)
  channel-innermost, as the bf16 route does, and rewrite it K-major and
  split in shared memory (`PCOpTf32::transform`). `emulate_lp` and
  `emulate_pc` run those GEMMs tile by tile in numpy: TMA box loads with
  out-of-bounds zeros, the 128-byte swizzle TMA writes, the transform's
  thread mapping, and wgmma's K-major view, at 32 x 32, 6 x 10 and 3 x 70.
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
    fuse_scores,
    patches_adjoint,
)

HD = WD = 32
C = 64
BM = 64  # rows of a tile (one wgmma m64)
ROW = 32  # float32 values in a 128-byte swizzle row: a K block


def tf32(x):
    """cvt.rna.tf32.f32 on a float32 tensor: the 13 low mantissa bits
    rounded off to nearest, ties away from zero, and zeroed."""
    bits = x.detach().contiguous().numpy().view(np.uint32)
    rounded = ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)
    return torch.from_numpy(rounded.copy())


def split(x):
    """The route's split of a float32 operand (`split_tf32`)."""
    big = tf32(x)
    return big, tf32(x - big)


def product(spec, a, b):
    """einsum(spec, a, b) as the route computes it: small big + big small +
    big big, each a product of TF32 values (exact in float32), summed in
    float32."""
    (ab, as_), (bb, bs) = split(a.float()), split(b.float())
    return torch.einsum(spec, as_, bb) + torch.einsum(spec, ab, bs) + torch.einsum(spec, ab, bb)


def one_rounding(spec, a, b):
    return torch.einsum(spec, tf32(a.float()), tf32(b.float()))


def tf32_scores(fd, bd, hd, wd, prod=product):
    bs, num_l = fd.shape[0], hd * wd
    fpat = extract_patches(fd, 3, 1).reshape(bs, num_l, -1)
    wpat = extract_patches(bd, 3, 1).reshape(bs, num_l, -1)
    nrm_raw = torch.sqrt(torch.sum(wpat * wpat, dim=-1, keepdim=True))  # CUDA cores
    return prod("blk,bpk->blp", wpat, fpat) / torch.clamp(nrm_raw, min=1e-4), nrm_raw


def tf32_forward(fd, bd, b_full, mm, hd, wd, scale=10.0):
    """`attention_v2_reference` with the score and the paste in 3xTF32:
    (y, s, probs, nrm_raw)."""
    bs, c = fd.shape[0], fd.shape[-1]
    s, nrm_raw = tf32_scores(fd, bd, hd, wd)
    g = mm[:, :, None]
    probs = torch.softmax(fuse_scores(s, wd) * g * scale, dim=1) * g
    raw = extract_patches(b_full, 4, 2).reshape(bs, hd * wd, -1)
    vals = product("blp,blk->bpk", probs, raw).reshape(bs, hd, wd, 4, 4, c)
    return _fold_overlap_add(vals, 2 * hd, 2 * wd, 2, 4), s, probs, nrm_raw


def tf32_backward(fd, bd, b_full, dy, probs, s, nrm_raw, mm, hd, wd, scale=10.0):
    """`attention_v2_bwd_reference` with its four GEMMs (dprobs, db_full,
    dfd, dbd) in 3xTF32."""
    bs, c, num_l = fd.shape[0], fd.shape[-1], hd * wd
    nrm = torch.clamp(nrm_raw, min=1e-4)
    g = mm[:, :, None]
    raw = extract_patches(b_full, 4, 2).reshape(bs, num_l, -1)
    dv = extract_patches(dy, 4, 2).reshape(bs, num_l, -1) / 4.0
    dprobs = product("blr,bpr->blp", raw, dv)
    draw = product("blp,bpr->blr", probs, dv)
    db_full = _fold_overlap_add(draw.reshape(bs, hd, wd, 4, 4, c), 2 * hd, 2 * wd, 2, 4) * 4.0
    dq = dprobs * g
    colsum = torch.sum(probs * dq, dim=1, keepdim=True)
    ds = fuse_adjoint(probs * (dq - colsum) * g * scale, wd)
    ds0 = ds / nrm
    dn = -torch.sum(ds * s, dim=2, keepdim=True) / nrm
    dnrm2 = torch.where(nrm_raw > 1e-4, dn * 0.5 / torch.clamp(nrm_raw, min=1e-12), 0.0)
    fpat = extract_patches(fd, 3, 1).reshape(bs, num_l, -1)
    wpat = extract_patches(bd, 3, 1).reshape(bs, num_l, -1)
    dfpat = product("blp,blk->bpk", ds0, wpat)
    dwpat = product("blp,bpk->blk", ds0, fpat) + 2.0 * wpat * dnrm2
    return (patches_adjoint(dfpat, hd, wd, c, 3), patches_adjoint(dwpat, hd, wd, c, 3), db_full)


@functools.lru_cache(maxsize=None)
def _case():
    """One sample, soft attention (fd scaled by 0.05), a hole band at the
    bottom (the sigma+ wrap reaches the last rows), float32 inputs and
    cotangent, the JAX forward's outputs and residuals and its gradients."""
    rng = np.random.default_rng(7)
    fd = rng.standard_normal((1, HD, WD, C)).astype(np.float32) * 0.05
    bd = rng.standard_normal((1, HD, WD, C)).astype(np.float32)
    b_full = rng.standard_normal((1, 2 * HD, 2 * WD, C)).astype(np.float32)
    dy = rng.standard_normal((1, 2 * HD, 2 * WD, C)).astype(np.float32)
    g = np.ones((1, HD, WD), np.float32)
    g[:, HD - HD // 3:] = 0.0
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


def test_tf32_rounding_is_cvt_rna():
    x = torch.tensor([1.0, 1.0 + 2.0**-11, 1.0 + 2.0**-12, -(1.0 + 2.0**-11), 1.0 + 3 * 2.0**-12,
                      0.1, -0.1, 3.0e-39])
    got = tf32(x)
    bits = got.numpy().view(np.uint32)
    assert not (bits & 0x1FFF).any()  # 10 mantissa bits left
    # a tie rounds away from zero, on either side of it
    assert got[1] == 1.0 + 2.0**-10 and got[3] == -(1.0 + 2.0**-10)
    assert got[2] == 1.0 and got[4] == 1.0 + 2.0**-10
    assert float(((got[5:7] - x[5:7]).abs() / x[5:7].abs()).max()) <= 2.0**-11


def test_split_keeps_float32_class_accuracy():
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(4096).astype(np.float32))
    big, small = split(x)
    assert float(((big - x).abs() / x.abs()).max()) > 2.0**-14  # one TF32 rounding is coarse
    assert float(((big + small - x).abs() / x.abs()).max()) <= 2.0**-22
    w = torch.from_numpy(np.random.default_rng(1).standard_normal(4096).astype(np.float32))
    # three products against the exact one, elementwise: ~2^-21 relative
    got = product("i,i->i", x, w).double()
    exact = x.double() * w.double()
    assert float(((got - exact).abs() / exact.abs()).max()) <= 2.0**-20


def test_forward_stays_within_the_float32_gates():
    case = _case()
    fd, bd, b_full, mm, _ = case["inputs"]
    probs_j, s_j, nrm_j = case["residuals"]
    y, s, probs, nrm = tf32_forward(fd, bd, b_full, mm, HD, WD)
    assert float((s - s_j).abs().max()) <= 2e-5
    assert float((probs - probs_j).abs().max()) <= 1e-4
    assert float(((nrm - nrm_j).abs() / nrm_j.abs().clamp_min(1e-6)).max()) <= 1e-5
    assert float((y - case["y"]).abs().max()) <= 3e-4
    assert float(probs_j.amax(dim=1).min()) < 0.9  # soft attention
    # and the split costs far less than the gates: against the plain version
    y32, s32, _, _ = ac.attention_v2_reference(fd, bd, b_full, mm, HD, WD, 10.0, True)
    assert float((s - s32).abs().max()) <= 2e-6
    assert float((y - y32).abs().max()) <= 3e-5


def test_one_tf32_rounding_breaks_the_score_gate():
    """Why three products: the score operands rounded once to TF32 put s
    outside its 2e-5 gate."""
    case = _case()
    fd, bd, _, _, _ = case["inputs"]
    s, _ = tf32_scores(fd, bd, HD, WD, prod=one_rounding)
    assert float((s - case["residuals"][1]).abs().max()) > 2e-5


def test_backward_stays_within_the_float32_gate():
    case = _case()
    fd, bd, b_full, mm, dy = case["inputs"]
    probs, s, nrm = case["residuals"]
    got = tf32_backward(fd, bd, b_full, dy, probs, s, nrm, mm, HD, WD)
    plain = ac.attention_v2_bwd_reference(fd, bd, b_full, dy, probs, s, nrm, mm, HD, WD, 10.0)
    for name, g, p, w in zip(("dfd", "dbd", "db_full"), got, plain, case["grads"]):
        top = float(w.abs().max())
        assert float((g - w).abs().max()) <= 1e-4 * top, (name, float((g - w).abs().max()), top)
        assert float((g - p).abs().max()) <= 1e-5 * top, name


# ---- the layouts, emulated in numpy ----


class TensorMap:
    """A tensor map's tiled box loads (element strides 1), in numpy. data
    holds the tensor outermost first (its shape is dims reversed); boxes
    and coordinates are innermost first. Elements outside [0, dims[i]) are
    zero."""

    def __init__(self, data, dims, box):
        assert data.shape == tuple(reversed(dims))
        self.data, self.dims, self.box = data, tuple(dims), tuple(box)

    def load(self, coords):
        """The box at coords, as rows of box[0] values (innermost), the
        outer dimensions flattened in order."""
        out = np.zeros(self.box[::-1], self.data.dtype)
        src, dst = [], []
        for c, b, d in zip(coords, self.box, self.dims):
            lo, hi = max(c, 0), min(c + b, d)
            if hi <= lo:
                return out.reshape(-1, self.box[0])
            src.append(slice(lo, hi))
            dst.append(slice(lo - c, hi - c))
        out[tuple(dst[::-1])] = self.data[tuple(src[::-1])]
        return out.reshape(-1, self.box[0])


def swizzled(r, e):
    """Index, in float32 values, of row r, value e of a tile of 128-byte
    rows in the 128-byte swizzle: 16-byte chunk e / 4 stored at chunk
    (e / 4) ^ (r % 8)."""
    return r * ROW + ((e // 4) ^ (r % 8)) * 4 + e % 4


def transform_indices():
    """`PCOpTf32::transform`'s loads and stores over its 128 threads: for
    each (thread, q, e), the index read from B as loaded (two 32 x 32
    halves, 1024 values each) and the index written in the K-major tile
    (64 rows of 32)."""
    t, q, e = np.meshgrid(np.arange(128), np.arange(4), np.arange(4), indexing="ij")
    c, kh = t % 64, t // 64
    k = kh * 16 + q * 4 + e
    src = (c // 32) * 1024 + k * ROW + (((c % 32) // 4) ^ (k % 8)) * 4 + c % 4
    dst = c * ROW + (((kh * 4 + q) ^ (c % 8)) * 4) + e
    return src.ravel(), dst.ravel()


SRC, DST = transform_indices()


def real(q, hd, wd):
    """`Geom::real`: the grid index of padded position q, or -1."""
    wdp, _ = ac.tc_geometry(hd, wd)
    i, j = q // wdp, q % wdp
    return np.where((i < hd) & (j < wd), i * wd + j, -1)


def window_tap(tap):
    return tap // 3 - 1, tap % 3 - 1


def paste_tap(phase, ab):
    return ab // 2 - phase // 2, ab % 2 - phase % 2


def split_np(x):
    """split() of a numpy array, the halves in float64."""
    big, small = split(torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32)))
    return big.double().numpy(), small.double().numpy()


def emulate_lp(a_map, b_map, hd, wd, kind):
    """lp_gemm_tf32: (64, 128) tiles over Cp / 32 channel blocks of each
    tap. kind "score": a_map bd, b_map fd (B, 1, hd, wd, Cp), window taps;
    "dprobs": the phase planes (B, 4, hd, wd, Cp) of b_full and dy, paste
    taps, / 4. Both maps split first (split_kernel). Written at the real
    (l, p); everything else stays NaN."""
    bs, phases, _, _, cp = a_map.shape
    wdp, _ = ac.tc_geometry(hd, wd)
    q, num_l = hd * wdp, hd * wd
    dims = (cp, wd, hd, phases, bs)
    wa, wb = min(wdp, BM), min(wdp, 128)
    box_a, box_b = (ROW, wa, BM // wa, 1, 1), (ROW, wb, 128 // wb, 1, 1)
    a_big, a_small = (TensorMap(m, dims, box_a) for m in split_np(a_map))
    b_big, b_small = (TensorMap(m, dims, box_b) for m in split_np(b_map))
    taps = [(0, *window_tap(t)) for t in range(9)] if kind == "score" else [
        (t // 4, *paste_tap(t // 4, t % 4)) for t in range(16)]
    out = np.full((bs, num_l, num_l), np.nan)
    for b in range(bs):
        for m0 in range(0, q, BM):
            for n0 in range(0, q, 128):
                acc = np.zeros((BM, 128))
                for ph, sy, sx in taps:
                    for k0 in range(0, cp, ROW):
                        at_a = (k0, m0 % wdp + sx, m0 // wdp + sy, ph, b)
                        at_b = (k0, n0 % wdp + sx, n0 // wdp + sy, ph, b)
                        ab, as_ = a_big.load(at_a), a_small.load(at_a)
                        bb, bs_ = b_big.load(at_b), b_small.load(at_b)
                        acc += as_ @ bb.T + ab @ bs_.T + ab @ bb.T
                ls, ps = real(m0 + np.arange(BM), hd, wd), real(n0 + np.arange(128), hd, wd)
                rows, cols = np.nonzero((ls[:, None] >= 0) & (ps[None, :] >= 0))
                out[b, ls[rows], ps[cols]] = acc[rows, cols] * (0.25 if kind == "dprobs" else 1.0)
    return out


def planes(x, hd, wd):
    """A float (B, L, P) matrix as the sweeps write it for a (P, C) GEMM:
    (B, L, kp), columns at their padded positions, zero at phantoms, split
    into big and small (split_rows_kernel, fuse_softmax_tc_kernel)."""
    _, kp = ac.tc_geometry(hd, wd)
    ps = real(np.arange(kp), hd, wd)
    pl = np.zeros((x.shape[0], x.shape[1], kp), np.float32)
    pl[:, :, ps >= 0] = x[:, :, ps[ps >= 0]]
    return split_np(pl)


def emulate_pc(pl, fmap, hd, wd, kind):
    """pc_gemm_tf32: (64 positions, 64 channels) tiles over kp / 32 K
    blocks of each tap. A: the split planes pl (B, L, kp) at the tile's rows
    minus the tap; B: fmap (B, phases, hd, wd, Cp) unsplit, its 32 K rows
    plus the tap, loaded as two 32-channel boxes into the swizzled layout,
    rewritten K-major and split by the transform's thread mapping, read as
    wgmma reads a K-major tile. kind "paste": phase planes, paste taps, per
    output phase, / 4, out (B, 4, L, C); "window": one map, window taps,
    out (B, 1, L, C). Written at the real m; NaN elsewhere."""
    bs, phases, _, _, cp = fmap.shape
    wdp, kp = ac.tc_geometry(hd, wd)
    num_l = hd * wd
    wa, wr = min(wdp, BM), min(wdp, ROW)
    a_big, a_small = (TensorMap(p.reshape(bs, hd, wd, kp), (kp, wd, hd, bs), (ROW, wa, BM // wa, 1))
                      for p in pl)
    b_map = TensorMap(fmap.astype(np.float32), (cp, wd, hd, phases, bs), (ROW, wr, ROW // wr, 1, 1))
    r, e = np.meshgrid(np.arange(ROW), np.arange(ROW), indexing="ij")
    as_loaded = swizzled(r, e)  # where TMA puts row r, value e of a box
    n, k = np.meshgrid(np.arange(64), np.arange(ROW), indexing="ij")
    as_read = swizzled(n, k)  # where wgmma reads row n, entry k of a K-major tile
    out = np.full((bs, phases, num_l, cp), np.nan)
    for b in range(bs):
        for phase in range(phases):
            taps = [paste_tap(phase, ab) for ab in range(4)] if kind == "paste" else [
                window_tap(t) for t in range(9)]
            for m0 in range(0, hd * wdp, BM):
                for c0 in range(0, cp, 64):
                    acc = np.zeros((BM, 64))
                    for sy, sx in taps:
                        for k0 in range(0, kp, ROW):
                            at = (k0, m0 % wdp - sx, m0 // wdp - sy, b)
                            ab, as_ = a_big.load(at), a_small.load(at)
                            loaded = np.zeros(2 * 1024, np.float32)
                            for half in range(2):
                                loaded[half * 1024 + as_loaded] = b_map.load(
                                    (c0 + ROW * half, k0 % wdp + sx, k0 // wdp + sy, phase, b))
                            big, small = np.zeros(64 * ROW), np.zeros(64 * ROW)
                            big[DST], small[DST] = split_np(loaded[SRC])
                            bb, bs_ = big[as_read].T, small[as_read].T  # (K, N)
                            acc += as_ @ bb + ab @ bs_ + ab @ bb
                    ms = real(m0 + np.arange(BM), hd, wd)
                    rows = np.nonzero(ms >= 0)[0]
                    out[b, phase, ms[rows], c0:c0 + 64] = acc[rows] * (0.25 if kind == "paste" else 1.0)
    return out


def test_transform_writes_every_value_once():
    """The transform's 128 threads read each of the 2048 loaded values once
    and write each of the K-major tile's 2048 once, the value of channel c,
    position k to row c, entry k."""
    assert sorted(SRC) == list(range(2048)) and sorted(DST) == list(range(2048))
    c, k = np.meshgrid(np.arange(64), np.arange(ROW), indexing="ij")
    loaded = np.zeros(2048)
    loaded[(c // 32) * 1024 + swizzled(k, c % 32)] = c * 100 + k  # TMA: row k, channel c
    tile = np.zeros(2048)
    tile[DST] = loaded[SRC]
    assert np.array_equal(tile[swizzled(c, k)], c * 100 + k)  # wgmma: row c, entry k


def _maps(bs, hd, wd, c, seed):
    rng = np.random.default_rng(seed)
    t = lambda *shape, k=1.0: (rng.standard_normal(shape) * k).astype(np.float32)
    fd, bd, b_full, dy = t(bs, hd, wd, c, k=0.05), t(bs, hd, wd, c), t(bs, 2 * hd, 2 * wd, c), \
        t(bs, 2 * hd, 2 * wd, c)
    cp = -(-c // 64) * 64
    pad = lambda x: ac.pad_channels(torch.from_numpy(x), cp)
    ph = lambda x: ac.to_phase_planes(torch.from_numpy(x), hd, wd, cp).numpy()
    return (torch.from_numpy(x) for x in (fd, bd, b_full, dy)), (
        pad(fd).numpy()[:, None], pad(bd).numpy()[:, None], ph(b_full), ph(dy))


@pytest.mark.parametrize("hd,wd,c", [(32, 32, 8), (6, 10, 20), (3, 70, 4), (16, 16, 64),
                                     (5, 33, 70)])
def test_tensor_map_emulation_gives_the_split_products(hd, wd, c):
    """Each of the four GEMM shapes, tile by tile in float64 from the
    emulated box loads, equals the same 3xTF32 products taken on the
    plain patches formulation (float64, split operands): score, dprobs,
    the paste per phase, and a window-tap (P, C) GEMM (dfd's, on ds0^T =
    probs^T as a stand-in operand)."""
    (fd, bd, b_full, dy), (fd_m, bd_m, bph, dyph) = _maps(1, hd, wd, c, seed=hd + wd)
    num_l = hd * wd
    f64 = lambda t: t.double()
    wpat = extract_patches(bd, 3, 1).reshape(1, num_l, -1)
    fpat = extract_patches(fd, 3, 1).reshape(1, num_l, -1)
    p64 = lambda spec, a, b: sum(torch.einsum(spec, f64(x), f64(y)) for x, y in (
        (split(a)[1], split(b)[0]), (split(a)[0], split(b)[1]), (split(a)[0], split(b)[0])))
    s = emulate_lp(bd_m, fd_m, hd, wd, "score")
    assert not np.isnan(s).any()
    np.testing.assert_allclose(s, p64("blk,bpk->blp", wpat, fpat).numpy(), rtol=0, atol=1e-10)

    raw = extract_patches(b_full, 4, 2).reshape(1, num_l, -1)
    dv = extract_patches(dy, 4, 2).reshape(1, num_l, -1)
    dprobs = emulate_lp(bph, dyph, hd, wd, "dprobs")
    np.testing.assert_allclose(dprobs, p64("blr,bpr->blp", raw, dv).numpy() / 4, rtol=0,
                               atol=1e-10)

    mm = torch.ones(1, num_l)
    mm[:, num_l - num_l // 3:] = 0.0
    _, _, probs, _ = ac.attention_v2_reference(fd, bd, b_full, mm, hd, wd, 10.0, True)
    pt = probs.transpose(1, 2).contiguous()  # the paste's A rows: query positions p
    y = emulate_pc(planes(pt.numpy(), hd, wd), bph, hd, wd, "paste")[..., :c]
    vals = p64("blp,blk->bpk", probs, raw).reshape(1, hd, wd, 4, 4, c)
    want = _fold_overlap_add(vals, 2 * hd, 2 * wd, 2, 4)  # (1, 2hd, 2wd, c)
    got = torch.from_numpy(y).reshape(1, 2, 2, hd, wd, c).permute(0, 3, 1, 4, 2, 5)
    np.testing.assert_allclose(got.reshape(want.shape).numpy(), want.numpy(), rtol=0, atol=1e-10)
    # and within the split of the float32 plain version
    y32 = ac.attention_v2_reference(fd, bd, b_full, mm, hd, wd, 10.0)
    assert float((got.reshape(want.shape) - y32.double()).abs().max()) <= 1e-5

    dfd = emulate_pc(planes(pt.numpy(), hd, wd), bd_m, hd, wd, "window")[:, 0, :, :c]
    dfpat = p64("blp,blk->bpk", probs, wpat)
    want = patches_adjoint(dfpat, hd, wd, c, 3).reshape(1, num_l, c)
    np.testing.assert_allclose(dfd, want.numpy(), rtol=0, atol=1e-10)
