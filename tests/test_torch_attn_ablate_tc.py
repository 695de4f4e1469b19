"""The stage ablation's tensor-core route, on the CPU.

The bf16 ablation (csrc/attention_tc_ablate.cu) runs only on the card. This
file holds on the CPU the two things about it that are not the forward's
(tests/test_torch_attention_tc.py holds those):

- Rounding per mode. `tc_route` below is the plain version of each mode as
  the route rounds it: the paste's A operand (probs, or what the mode puts
  in their place) split into hi + lo bf16 (`split_bf16`), except for
  paste_bf16, which rounds it once to bf16; fold_norm splits e * g, scales
  hi + lo by the column's 1/sum and splits again, as its paste does in
  shared memory; y rounded once to bf16. At 1 x 32 x 32 x 64, soft
  attention, bf16-valued inputs, each mode's emulation stays within
  `attn_ablate.ablate_within`'s bf16 tolerance of `ablate_reference` (y's
  1e-3 + 1.6e-2 |y|, two bf16 ulps, plus 1e-5 of the largest output, plus
  two bf16 straddles of the largest probability times the largest raw
  value / 4 for paste_bf16; no_paste and floor exactly zero): the gate the
  card's output is held to. `full`'s emulation also stays within the bf16
  gate (1e-3 + 1.6e-2 |y|) of the JAX package's `run(mode="full")` in
  float32, run in interpret mode (a fixture patches `pallas_call`, as
  tests/test_torch_attn_ablate.py does).
- The natural-layout tensor map. The paste reads b_full (B, 2hd, 2wd, Cp)
  through a 5-D map (Cp, 2, wd, 2hd, B) with element stride 2 on the pixel
  rows (`natural_map` in the .cu file). `tma_box` emulates a TMA box load
  in numpy (out-of-bounds elements zero, ceil(box / stride) elements a
  dimension, the rule cuda.h states), and every paste tile
  (each tap, each output phase, every K block of positions, phantom
  columns included) read through that map equals exactly the tile the
  phase-plane map reads from `to_phase_planes`.
"""

import functools

import jax
import jax.experimental.pallas as jpl
import jax.numpy as jnp
import numpy as np
import pytest
import torch

_cache_dir = jax.config.jax_compilation_cache_dir
from experiments import attn_ablate as jab  # noqa: E402

jax.config.update("jax_compilation_cache_dir", _cache_dir)

from healthivert_tpu_torch.experiments import attn_ablate as tab  # noqa: E402
from healthivert_tpu_torch.ops import attention_cuda as ac  # noqa: E402
from healthivert_tpu_torch.ops.contextual_attention import (  # noqa: E402
    _fold_overlap_add,
    extract_patches,
    fuse_scores,
)

HD = WD = 32
C = 64


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    orig = jpl.pallas_call
    monkeypatch.setattr(jpl, "pallas_call",
                        lambda *a, **k: orig(*a, **{**k, "interpret": True}))


def split_bf16(x):
    """The route's split of a float32 operand (`split` in
    csrc/attention_tc_kernels.cuh): hi = bf16(x), lo = bf16(x - hi)."""
    hi = x.to(torch.bfloat16)
    return hi, (x - hi.float()).to(torch.bfloat16)


def split_sum(x):
    """x as the tensor cores see it after split_bf16: hi + lo in float32."""
    hi, lo = split_bf16(x)
    return hi.float() + lo.float()


def tc_route(fd, bd, b_full, mm, hd, wd, mode, scale=10.0):
    """One mode of the ablation with the tensor-core route's roundings (see
    the module docstring); float32 arithmetic otherwise, y in bf16."""
    if mode in ("no_paste", "floor"):
        return torch.zeros_like(b_full, dtype=torch.bfloat16)
    bs, c = fd.shape[0], fd.shape[-1]
    num_l = hd * wd
    if mode == "no_score":
        s = torch.full((bs, num_l, num_l), 0.5)
    else:
        fpat = extract_patches(fd, 3, 1).reshape(bs, num_l, -1)
        wpat = extract_patches(bd, 3, 1).reshape(bs, num_l, -1)
        nrm = torch.sqrt(torch.sum(wpat * wpat, dim=-1, keepdim=True))
        s = torch.einsum("blk,bpk->blp", wpat, fpat) / torch.clamp(nrm, min=1e-4)
    fused = s if mode == "no_fuse" else fuse_scores(s, wd)
    g = mm[:, :, None]
    if mode == "no_softmax":
        a = split_sum(fused)
    else:
        logits = fused * g * scale
        e = torch.exp(logits - logits.amax(dim=1, keepdim=True))
        inv = 1.0 / e.sum(dim=1, keepdim=True)
        if mode == "fold_norm":
            a = split_sum(split_sum(e * g) * inv)
        elif mode == "paste_bf16":
            a = (e * inv * g).to(torch.bfloat16).float()
        else:
            a = split_sum(e * inv * g)
    raw = extract_patches(b_full, 4, 2).reshape(bs, num_l, -1)
    vals = torch.einsum("blp,blk->bpk", a, raw).reshape(bs, hd, wd, 4, 4, c)
    return _fold_overlap_add(vals, 2 * hd, 2 * wd, 2, 4).to(torch.bfloat16)


def _bf16_valued(a):
    return torch.from_numpy(a).to(torch.bfloat16).float()


@functools.lru_cache(maxsize=None)
def _case():
    """One sample, soft attention (fd scaled by 0.05), a hole band at the
    bottom, bf16-valued float32 inputs."""
    rng = np.random.default_rng(5)
    fd = _bf16_valued(rng.standard_normal((1, HD, WD, C)).astype(np.float32) * 0.05)
    bd = _bf16_valued(rng.standard_normal((1, HD, WD, C)).astype(np.float32))
    b_full = _bf16_valued(rng.standard_normal((1, 2 * HD, 2 * WD, C)).astype(np.float32))
    g = np.ones((1, HD, WD), np.float32)
    g[:, HD - HD // 3:] = 0.0
    return fd, bd, b_full, torch.from_numpy(g.reshape(1, -1))


@pytest.mark.parametrize("mode", tab.MODES)
def test_route_rounding_stays_within_ablate_within(mode):
    fd, bd, b_full, mm = _case()
    got = tc_route(fd, bd, b_full, mm, HD, WD, mode)
    b16 = lambda t: t.to(torch.bfloat16)
    want = tab.ablate_reference(b16(fd), b16(bd), b16(b_full), mm, HD, WD, mode=mode)
    assert got.dtype == want.dtype == torch.bfloat16 and got.shape == b_full.shape
    _, _, probs, _ = ac.attention_v2_reference(fd, bd, b_full, mm, HD, WD, 10.0, True)
    assert float(probs.amax(dim=1).min()) < 0.9  # soft attention
    ok, err = tab.ablate_within(got, want, mode, float(probs.max()), float(b_full.abs().max()))
    assert ok, err
    if mode not in ("no_paste", "floor"):
        assert float(want.float().abs().max()) > 0.1  # the comparison is not of zeros


def test_full_rounding_stays_within_the_gate_of_jax_run():
    fd, bd, b_full, mm = _case()
    want = np.asarray(jab.run(*map(jnp.asarray, (fd.numpy(), bd.numpy(), b_full.numpy(),
                                                 mm.numpy())), HD, WD, mode="full"))
    want = torch.from_numpy(want)
    got = tc_route(fd, bd, b_full, mm, HD, WD, "full").float()
    excess = (got - want).abs() - (1e-3 + 1.6e-2 * want.abs())
    assert float(excess.max()) <= 0.0, float((got - want).abs().max())


# ---- the natural-layout tensor map ----

BK = BM = 64  # a tile's channels and positions (csrc/attention_tc.cuh)


def natural_map(hd, wd, cp, bs):
    """`natural_map` of csrc/attention_tc_ablate.cu: dims, box and element
    strides, innermost first, of b_full (B, 2hd, 2wd, Cp) as the paste's B
    operand."""
    wdp, _ = ac.tc_geometry(hd, wd)
    w = min(wdp, BM)
    return (cp, 2, wd, 2 * hd, bs), (BK, 1, w, 2 * (BM // w), 1), (1, 1, 1, 2, 1)


def phase_plane_map(hd, wd, cp, bs):
    """`feature_map(.., phases=4, positions=BM)` of
    csrc/attention_tc_kernels.cuh over the phase planes (B, 4, hd, wd, Cp)."""
    wdp, _ = ac.tc_geometry(hd, wd)
    w = min(wdp, BM)
    return (cp, wd, hd, 4, bs), (BK, w, BM // w, 1, 1), (1, 1, 1, 1, 1)


def tma_box(data, dims, box, estride, coords):
    """A TMA tiled box load, in numpy. data holds the tensor outermost
    first (its shape is dims reversed); box, estride and coords are
    innermost first. Dimension i yields ceil(box[i] / estride[i]) elements,
    at coords[i] + estride[i] * k (dimension 0's stride is ignored), zero
    where that falls outside [0, dims[i]). Returns the box outermost
    first."""
    assert data.shape == tuple(reversed(dims))
    idx, ok = [], []
    for i, (d, b, e, c) in enumerate(zip(dims, box, estride, coords)):
        e = 1 if i == 0 else e
        at = c + e * np.arange(-(-b // e))
        idx.append(np.clip(at, 0, d - 1))
        ok.append((at >= 0) & (at < d))
    idx, ok = idx[::-1], ok[::-1]
    # (np.ix_ would read boolean arrays as index lists: pass 0/1 instead)
    mask = functools.reduce(np.multiply, np.ix_(*[o.astype(np.int8) for o in ok])) > 0
    return np.where(mask, data[np.ix_(*idx)], 0.0)


@pytest.mark.parametrize("hd,wd", [(32, 32), (6, 10), (3, 70)])
def test_natural_map_reads_the_phase_plane_tiles(hd, wd):
    """Every paste tile read through the stride-2 map over natural b_full
    equals, exactly, the one the forward's map reads from its phase planes;
    (6, 10) and (3, 70) put phantom columns (wd < wdp = 16, 128) in the
    tiles, and every tap reaches past each edge of the grid."""
    bs, cp = 2, 64
    wdp, kp = ac.tc_geometry(hd, wd)
    rng = np.random.default_rng(0)
    b_full = torch.from_numpy(rng.standard_normal((bs, 2 * hd, 2 * wd, cp)).astype(np.float32))
    planes = ac.to_phase_planes(b_full, hd, wd, cp).numpy()
    nat = b_full.numpy().reshape(bs, 2 * hd, wd, 2, cp)  # (Cp, 2, wd, 2hd, B) reversed
    n_dims, n_box, n_es = natural_map(hd, wd, cp, bs)
    p_dims, p_box, p_es = phase_plane_map(hd, wd, cp, bs)
    # what cuTensorMapEncodeTiled takes: boxes of at most 256, element strides of at most
    # 8, an inner box of 128 bytes (the 128-byte swizzle's limit, a multiple
    # of 16), byte strides of the outer dims multiples of 16
    assert max(n_box) <= 256 and max(n_es) <= 8 and n_box[0] * 2 == 128
    assert all(2 * int(np.prod(n_dims[:i])) % 16 == 0 for i in range(1, 5))
    # one tile: BM positions of BK channels (TILE_BYTES, the stage's expect_tx)
    assert int(np.prod([-(-b // e) for b, e in zip(n_box, n_es)])) == BM * BK
    tiles = 0
    for b in range(bs):
        for k0 in range(0, kp, BM):
            i0, j0 = k0 // wdp, k0 % wdp
            for phase in range(4):
                r, t = phase // 2, phase % 2
                for ab in range(4):
                    sy, sx = ab // 2 - r, ab % 2 - t
                    got = tma_box(nat, n_dims, n_box, n_es, (0, t, j0 + sx, 2 * (i0 + sy) + r, b))
                    want = tma_box(planes, p_dims, p_box, p_es, (0, j0 + sx, i0 + sy, phase, b))
                    np.testing.assert_array_equal(got.reshape(-1, BK), want.reshape(-1, BK))
                    tiles += 1
    assert tiles == bs * (kp // BM) * 16


def test_tma_box_emulation_fills_zeros_outside():
    data = np.arange(12, dtype=np.float32).reshape(3, 4)  # dims (4, 3)
    got = tma_box(data, (4, 3), (2, 4), (1, 2), (-1, -1))
    # rows -1 and 1 (stride 2, box 4 -> 2 rows), columns -1 and 0
    np.testing.assert_array_equal(got, [[0.0, 0.0], [0.0, 4.0]])
