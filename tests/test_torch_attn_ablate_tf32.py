"""The stage ablation's float32 tensor-core route (3xTF32), on the CPU.

The float32 ablation (csrc/attention_tf32_ablate.cu) runs only on the card.
Its modes are instantiations of the float32 forward's kernels
(tests/test_torch_attention_tf32.py holds those), as the bf16 ablation's
are of the bf16 forward's (tests/test_torch_attn_ablate_tc.py). This file
holds on the CPU what the float32 ablation adds:

- Rounding per mode. `tf32_route` below is the plain version of each mode
  as the route rounds it: the score and the paste in 3xTF32 (`product`),
  except for paste_bf16, whose sweep writes probs rounded to bf16 and whose
  transform rounds b_full to bf16, one TF32 product a step (bf16 values and
  their products are exact there); fold_norm splits e * g, scales big +
  small by the column's 1/sum and splits again, as its transform does. At
  1 x 32 x 32 x 64, soft attention, a bottom hole band and float32 inputs,
  each mode stays within `attn_ablate.ablate_within`'s float32 tolerance of
  `ablate_reference` (y's atol 3e-4 plus 1e-5 of the largest output, plus
  two bf16 straddles of the largest probability times the largest raw
  value / 4 for paste_bf16; no_paste and floor exactly zero): the gate the
  card's output is held to (seen: 2.1e-5 in full, 1.1e-4 in paste_bf16,
  at most 1.9e-5 in the others). `full`'s emulation is the float32
  forward's (`tf32_forward`), and stays within y's float32 gate (3e-4) of
  the JAX package's `run(mode="full")` in interpret mode (seen 2.2e-5; a
  fixture patches `pallas_call`, as tests/test_torch_attn_ablate.py does).
- Truncated sums. The tensor cores add each step's products to the float32
  sums and truncate toward zero; over the paste's 4 x kp positions the
  drift of a large sum breaks no_softmax's gate unless the sums are
  promoted (`paste_sums`, the card's PCOpTf32::PROMOTE).
- The natural-layout tensor map. The float32 paste reads b_full (B, 2hd,
  2wd, Cp) through `natural_map<float>` (csrc/attention_ablate.cuh): dims
  (Cp, 2, wd, 2hd, B), boxes of 32 channels (128 bytes) by 32 positions,
  element stride 2 on the pixel rows. Every paste tile's two 32-channel
  boxes read through it equal exactly those the forward's phase-plane map
  reads from `to_phase_planes`.
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
from test_torch_attention_tf32 import product, split, tf32_forward, tf32_scores  # noqa: E402
from test_torch_attn_ablate_tc import tma_box  # noqa: E402

HD = WD = 32
C = 64
ROW = 32  # float32 values in a 128-byte swizzle row: a box's channels and positions


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    orig = jpl.pallas_call
    monkeypatch.setattr(jpl, "pallas_call",
                        lambda *a, **k: orig(*a, **{**k, "interpret": True}))


def bf16_valued(x):
    return x.to(torch.bfloat16).float()


def tf32_route(fd, bd, b_full, mm, hd, wd, mode, scale=10.0):
    """One mode of the ablation with the float32 route's roundings (see the
    module docstring); float32 arithmetic otherwise."""
    if mode in ("no_paste", "floor"):
        return torch.zeros_like(b_full)
    bs, c = fd.shape[0], fd.shape[-1]
    num_l = hd * wd
    s = torch.full((bs, num_l, num_l), 0.5) if mode == "no_score" else tf32_scores(fd, bd, hd, wd)[0]
    fused = s if mode == "no_fuse" else fuse_scores(s, wd)
    g = mm[:, :, None]
    raw = extract_patches(b_full, 4, 2).reshape(bs, num_l, -1)
    if mode in ("full", "no_score", "no_fuse"):
        vals = product("blp,blk->bpk", torch.softmax(fused * g * scale, dim=1) * g, raw)
    elif mode == "no_softmax":
        vals = product("blp,blk->bpk", fused, raw)
    else:
        logits = fused * g * scale
        e = torch.exp(logits - logits.amax(dim=1, keepdim=True))
        inv = 1.0 / e.sum(dim=1, keepdim=True)
        if mode == "paste_bf16":
            vals = torch.einsum("blp,blk->bpk", bf16_valued(e * inv * g), bf16_valued(raw))
        else:  # fold_norm
            big, small = split(e * g)
            vals = product("blp,blk->bpk", (big + small) * inv, raw)
    return _fold_overlap_add(vals.reshape(bs, hd, wd, 4, 4, c), 2 * hd, 2 * wd, 2, 4)


@functools.lru_cache(maxsize=None)
def _case():
    """One sample, soft attention (fd scaled by 0.05), a hole band at the
    bottom, float32 inputs."""
    rng = np.random.default_rng(11)
    t = lambda *shape, k=1.0: torch.from_numpy(rng.standard_normal(shape).astype(np.float32) * k)
    fd, bd, b_full = t(1, HD, WD, C, k=0.05), t(1, HD, WD, C), t(1, 2 * HD, 2 * WD, C)
    g = torch.ones(1, HD, WD)
    g[:, HD - HD // 3:] = 0.0
    return fd, bd, b_full, g.reshape(1, -1)


@pytest.mark.parametrize("mode", tab.MODES)
def test_route_rounding_stays_within_ablate_within(mode):
    fd, bd, b_full, mm = _case()
    got = tf32_route(fd, bd, b_full, mm, HD, WD, mode)
    want = tab.ablate_reference(fd, bd, b_full, mm, HD, WD, mode=mode)
    assert got.dtype == want.dtype == torch.float32 and got.shape == b_full.shape
    _, _, probs, _ = ac.attention_v2_reference(fd, bd, b_full, mm, HD, WD, 10.0, True)
    assert float(probs.amax(dim=1).min()) < 0.9  # soft attention
    ok, err = tab.ablate_within(got, want, mode, float(probs.max()), float(b_full.abs().max()))
    assert ok, err
    if mode not in ("no_paste", "floor"):
        assert float(want.abs().max()) > 0.1  # the comparison is not of zeros


def test_full_is_the_float32_forward():
    fd, bd, b_full, mm = _case()
    want = tf32_forward(fd, bd, b_full, mm, HD, WD)[0]
    assert torch.equal(tf32_route(fd, bd, b_full, mm, HD, WD, "full"), want)


def test_full_rounding_stays_within_the_gate_of_jax_run():
    fd, bd, b_full, mm = _case()
    want = np.array(jab.run(*map(jnp.asarray, (fd.numpy(), bd.numpy(), b_full.numpy(),
                                                mm.numpy())), HD, WD, mode="full"))
    got = tf32_route(fd, bd, b_full, mm, HD, WD, "full")
    err = float((got - torch.from_numpy(want)).abs().max())
    assert err <= 3e-4, err


# ---- the natural-layout tensor map ----


def natural_map(hd, wd, cp, bs):
    """`natural_map<float>` of csrc/attention_ablate.cuh: dims, box and
    element strides, innermost first, of b_full (B, 2hd, 2wd, Cp)."""
    wdp, _ = ac.tc_geometry(hd, wd)
    w = min(wdp, ROW)
    return (cp, 2, wd, 2 * hd, bs), (ROW, 1, w, 2 * (ROW // w), 1), (1, 1, 1, 2, 1)


def phase_plane_map(hd, wd, cp, bs):
    """`feature_map<float>(.., phases=4, positions=32)`, the float32
    forward's map of the phase planes (B, 4, hd, wd, Cp)."""
    wdp, _ = ac.tc_geometry(hd, wd)
    w = min(wdp, ROW)
    return (cp, wd, hd, 4, bs), (ROW, w, ROW // w, 1, 1), (1, 1, 1, 1, 1)


@pytest.mark.parametrize("hd,wd", [(32, 32), (6, 10), (3, 70)])
def test_natural_map_reads_the_phase_plane_tiles(hd, wd):
    """Every paste tile (each tap, each output phase, every K block of 32
    positions, both 32-channel halves) read through the stride-2 map over
    natural b_full equals, exactly, the one the phase-plane map reads;
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
    # what cuTensorMapEncodeTiled takes: boxes of at most 256, element
    # strides of at most 8, an inner box of 128 bytes (the 128-byte
    # swizzle's limit), byte strides of the outer dims multiples of 16
    assert max(n_box) <= 256 and max(n_es) <= 8 and n_box[0] * 4 == 128
    assert all(4 * int(np.prod(n_dims[:i])) % 16 == 0 for i in range(1, 5))
    # one box: 32 positions of 32 channels, half the stage's B tile
    assert int(np.prod([-(-b // e) for b, e in zip(n_box, n_es)])) == ROW * ROW
    tiles = 0
    for b in range(bs):
        for k0 in range(0, kp, ROW):
            i0, j0 = k0 // wdp, k0 % wdp
            for phase in range(4):
                r, t = phase // 2, phase % 2
                for ab in range(4):
                    sy, sx = ab // 2 - r, ab % 2 - t
                    for c0 in range(0, cp, ROW):
                        got = tma_box(nat, n_dims, n_box, n_es,
                                      (c0, t, j0 + sx, 2 * (i0 + sy) + r, b))
                        want = tma_box(planes, p_dims, p_box, p_es, (c0, j0 + sx, i0 + sy, phase, b))
                        np.testing.assert_array_equal(got.reshape(-1, ROW), want.reshape(-1, ROW))
                        tiles += 1
    assert tiles == bs * (kp // ROW) * 16 * (cp // ROW)


# ---- the promoted sums of the (P, C) GEMMs ----


def rz(x):
    """float64 values rounded to float32 toward zero."""
    f = x.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(x)
    f[over] = np.nextafter(f[over], np.float32(0))
    return f


def paste_sums(a, b, promote):
    """The paste's float32 sums of the products a @ b (K = 4 taps x kp) as
    the tensor cores take them: each 8-deep step's three split products
    added to the sums and the result truncated toward zero; with promote,
    the products restarted every `promote` stages of 32 and their sums added
    (round to nearest) to sums kept in registers."""
    (ab, as_), (bb, bs_) = (tuple(t.double().numpy() for t in split(x)) for x in (a, b))
    part = np.zeros((a.shape[0], b.shape[1]), np.float32)
    sums = np.zeros_like(part)
    for k0 in range(0, a.shape[1], 8):
        if promote and k0 and k0 % (32 * promote) == 0:
            sums, part = sums + part, np.zeros_like(part)
        for x, y in ((as_, bb), (ab, bs_), (ab, bb)):
            part = rz(part.astype(np.float64) + x[:, k0:k0 + 8] @ y[k0:k0 + 8])
    return sums + part


def test_promoted_sums_keep_no_softmax_within_its_gate():
    """no_softmax pastes the unnormalised fused scores, so the paste's sums
    grow large (y up to ~40); truncated over 4 x 1024 positions in one run,
    as the tensor cores add, they drift past y's float32 gate. The card saw
    1.4e-3 at 2 x 32 x 32 x 64 (tests/test_torch_cuda_kernel.py) before the
    (P, C) GEMMs promoted their sums every 4 stages (PCOpTf32::PROMOTE).
    Emulated here on 48 outputs of one phase: 1.4e-3 in one run, 4.1e-5
    promoted, against a gate of 6.9e-4."""
    fd, bd, b_full, mm = _case()
    fused = fuse_scores(tf32_scores(fd, bd, HD, WD)[0], WD)[0]  # (L, P)
    bph = ac.to_phase_planes(b_full, HD, WD, C)[0, 0]  # output phase (0, 0)
    pt = fused.T.reshape(HD, WD, -1)  # probs^T stands in: row p, column l
    a, b = [], []
    for ab in range(4):  # the paste's taps of phase (0, 0): (sy, sx) = (ab / 2, ab % 2)
        sy, sx = ab // 2, ab % 2
        a.append(torch.nn.functional.pad(pt, (0, 0, sx, 0, sy, 0))[:HD, :WD].reshape(HD * WD, -1))
        b.append(torch.nn.functional.pad(bph, (0, 0, 0, sx, 0, sy))[sy:, sx:].reshape(HD * WD, C))
    rows = np.random.default_rng(0).choice(HD * WD, 48, replace=False)
    a, b = torch.cat(a, dim=1)[rows], torch.cat(b, dim=0)
    exact = a.double().numpy() @ b.double().numpy()
    one_run, promoted = (np.abs(paste_sums(a, b, p) - exact).max() / 4 for p in (0, 4))
    gate = 3e-4 + tab.ABLATE_REL * float(np.abs(exact).max()) / 4
    assert one_run > gate and promoted <= gate / 4, (one_run, promoted, gate)
