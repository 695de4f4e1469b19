"""Port vs JAX package on the CPU: the contextual-attention backward.

`attention_v2_bwd_reference` is the port's CPU path for the gradient and
the CUDA backward kernel's oracle on the card. It is held here against the
JAX package's XLA backward `_att_bwd_xla` and its Pallas backward
`attention_v2_bwd(interpret=True)`, on the residuals of the JAX forward
and random cotangents, with the gate's hole band in the middle, at the top
and at the bottom of the query grid (the sigma+ wrap of the fuse adjoint
reaches the last rows only with a bottom band) and soft attention (the
foreground scaled by 0.05).

Tolerances (float32 on both sides, sums in different orders):
- reference vs `_att_bwd_xla` and vs the Pallas backward: rtol 1e-4 and
  atol 1e-4, as tests/test_attention_pallas.py holds those two together
  (dfd reaches ~100: the gradient of the scores is scaled by 10 and divided
  by the patch norm);
- the autograd Function vs torch.autograd through `attention_v2_reference`:
  rtol 1e-4, atol 1e-4 (two derivations of one float32 gradient);
- the whole `contextual_attention` gradient vs jax.grad of the JAX function
  with use_pallas=False and a sum(y cos y) loss: rtol 2e-3, atol 2e-5, as
  `test_custom_vjp_gradients_match_xla` holds the JAX package's custom VJP.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import healthivert_tpu.ops.attention_pallas as ap
from healthivert_tpu.ops.contextual_attention import (
    contextual_attention as jax_contextual_attention,
)
from healthivert_tpu_torch.ops import contextual_attention as ca
from healthivert_tpu_torch.ops.attention_cuda import (
    AttentionV2Function,
    attention_v2,
    attention_v2_bwd,
    attention_v2_bwd_reference,
    attention_v2_reference,
)

BANDS = ["middle", "top", "bottom"]
NAMES = ("dfd", "dbd", "db_full")


def _inputs(hd, c, seed=0):
    """Three samples, one per band position of the gate's hole, and a
    random output cotangent."""
    rng = np.random.default_rng(seed)
    b = len(BANDS)
    fd = rng.standard_normal((b, hd, hd, c)).astype(np.float32) * 0.05
    bd = rng.standard_normal((b, hd, hd, c)).astype(np.float32)
    b_full = rng.standard_normal((b, 2 * hd, 2 * hd, c)).astype(np.float32)
    g = np.ones((b, hd, hd), np.float32)
    third = hd // 3
    g[0, third : 2 * third] = 0.0
    g[1, :third] = 0.0
    g[2, hd - third :] = 0.0
    dy = rng.standard_normal((b, 2 * hd, 2 * hd, c)).astype(np.float32)
    return fd, bd, b_full, g.reshape(b, -1), dy


@functools.lru_cache(maxsize=None)
def _all_three(hd, c):
    """(port reference, JAX XLA backward, JAX Pallas backward), all on the
    JAX forward's residuals."""
    fd, bd, b_full, mm, dy = _inputs(hd, c)
    j = tuple(map(jnp.asarray, (fd, bd, b_full, mm, dy)))
    _, s, probs, nrm = ap.attention_v2(
        j[0], j[1], j[2], j[3], hd, hd, 10.0, interpret=True, emit_residuals=True
    )
    xla = ap._att_bwd_xla(hd, hd, 10.0, (j[0], j[1], j[2], j[3], s, probs, nrm), j[4])[:3]
    pallas = ap.attention_v2_bwd(j[0], j[1], j[2], j[4], probs, s, nrm, j[3], hd, hd,
                                 10.0, interpret=True)
    t = lambda a: torch.from_numpy(np.array(a))
    got = attention_v2_bwd_reference(t(fd), t(bd), t(b_full), t(dy), t(probs), t(s),
                                     t(nrm), t(mm), hd, hd, 10.0)
    return ([g.numpy() for g in got], [np.asarray(w) for w in xla],
            [np.asarray(w) for w in pallas], np.asarray(probs))


@pytest.mark.parametrize("band", BANDS)
@pytest.mark.parametrize("c", [4, 64])
@pytest.mark.parametrize("hd", [8, 16])
def test_reference_matches_xla_and_pallas_backward(hd, c, band):
    i = BANDS.index(band)
    got, xla, pallas, probs = _all_three(hd, c)
    for name, g, w, k in zip(NAMES, got, xla, pallas):
        np.testing.assert_allclose(g[i], w[i], rtol=1e-4, atol=1e-4, err_msg=f"xla {name}")
        np.testing.assert_allclose(g[i], k[i], rtol=1e-4, atol=1e-4, err_msg=f"pallas {name}")
        assert np.abs(w[i]).max() > 0, name
    # the comparison covers soft attention, not only one-hot columns
    assert probs[i].max(axis=0).min() < 0.9


def test_function_gradient_matches_autograd_through_reference():
    fd, bd, b_full, mm, dy = map(torch.from_numpy, _inputs(8, 4, seed=2))
    leaves = lambda: [t.clone().requires_grad_(True) for t in (fd, bd, b_full)]
    want_in, got_in = leaves(), leaves()
    y = attention_v2_reference(*want_in, mm, 8, 8, 10.0)
    want = torch.autograd.grad((y * dy).sum(), want_in)
    y2 = AttentionV2Function.apply(*got_in, mm, 8, 8, 10.0)
    torch.testing.assert_close(y2, y)
    got = torch.autograd.grad((y2 * dy).sum(), got_in)
    for name, g, w in zip(NAMES, got, want):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4, msg=name)


def test_cpu_tensors_take_the_plain_versions_in_both_directions():
    fd, bd, b_full, mm, dy = map(torch.from_numpy, _inputs(8, 4, seed=3))
    before = (attention_v2.launches, attention_v2_bwd.launches)
    ins = [t.clone().requires_grad_(True) for t in (fd, bd, b_full)]
    y = AttentionV2Function.apply(*ins, mm, 8, 8, 10.0)
    (y * dy).sum().backward()
    assert all(t.grad is not None for t in ins)
    assert (attention_v2.launches, attention_v2_bwd.launches) == before


def _feature_case(seed=1):
    rng = np.random.default_rng(seed)
    f = rng.standard_normal((2, 16, 16, 4)).astype(np.float32)
    mask = np.zeros((2, 64, 64, 1), np.float32)
    mask[0, 20:44] = 1.0  # band in the middle
    mask[1, 40:64] = 1.0  # band at the bottom
    return f, mask


def test_contextual_attention_gradient_matches_jax():
    f, mask = _feature_case()
    jm = jnp.asarray(mask)

    def loss(x):
        y = jax_contextual_attention(x, x, jm, use_pallas=False).y
        return jnp.sum(y * jnp.cos(y))

    want_l, want_g = jax.value_and_grad(loss)(jnp.asarray(f))
    ft = torch.from_numpy(f).requires_grad_(True)
    y = ca.contextual_attention(ft, ft, torch.from_numpy(mask)).y
    got_l = torch.sum(y * torch.cos(y))
    got_l.backward()
    assert float(got_l.detach()) == pytest.approx(float(want_l), rel=1e-5)
    np.testing.assert_allclose(ft.grad.numpy(), np.asarray(want_g), rtol=2e-3, atol=2e-5)


def test_contextual_attention_routes_by_autograd():
    """The Function wherever autograd records, with offsets or without;
    no_grad is a plain forward. The offsets path gives the same y, the same
    gradient and the same offsets as the paths beside it."""
    f, mask = map(torch.from_numpy, _feature_case())
    with torch.no_grad():
        plain = ca.contextual_attention(f, f, mask).y
        plain_offsets = ca.contextual_attention(f, f, mask, compute_offsets=True)
    assert plain.grad_fn is None and plain_offsets.y.grad_fn is None
    live = f.clone().requires_grad_(True)
    y = ca.contextual_attention(live, live, mask).y
    assert y.grad_fn is not None
    torch.testing.assert_close(y.detach(), plain)
    with_offsets = ca.contextual_attention(live, live, mask, compute_offsets=True)
    torch.testing.assert_close(with_offsets.y.detach(), plain)
    assert with_offsets.y.grad_fn is not None
    assert torch.equal(with_offsets.offsets, plain_offsets.offsets)
    cot = torch.from_numpy(np.random.default_rng(4).standard_normal(y.shape).astype(np.float32))
    want = torch.autograd.grad((y * cot).sum(), live)[0]
    got = torch.autograd.grad((with_offsets.y * cot).sum(), live)[0]
    assert torch.equal(got, want)


def test_contextual_attention_offsets_gradient_matches_jax():
    """compute_offsets=True under grad: the gradient through the attention
    against jax.grad of the JAX XLA formulation with offsets
    (use_pallas=False, compute_offsets=True), and the offsets against its
    offsets. Separate foreground and background, so that each gets its own
    gradient; a random cotangent; f32, within 1e-5 of each gradient's
    largest entry (two derivations of one float32 gradient)."""
    f, mask = _feature_case()
    rng = np.random.default_rng(5)
    b = rng.standard_normal(f.shape).astype(np.float32)
    cot = rng.standard_normal(f.shape).astype(np.float32)
    jm, jc = jnp.asarray(mask), jnp.asarray(cot)

    def loss(x, y):
        return jnp.sum(jax_contextual_attention(x, y, jm, use_pallas=False,
                                                compute_offsets=True).y * jc)

    want = jax.grad(loss, argnums=(0, 1))(jnp.asarray(f), jnp.asarray(b))
    want_off = jax_contextual_attention(jnp.asarray(f), jnp.asarray(b), jm, use_pallas=False,
                                        compute_offsets=True).offsets
    ft, bt = (torch.from_numpy(a).requires_grad_(True) for a in (f, b))
    out = ca.contextual_attention(ft, bt, torch.from_numpy(mask), compute_offsets=True)
    got = torch.autograd.grad((out.y * torch.from_numpy(cot)).sum(), (ft, bt))
    np.testing.assert_array_equal(out.offsets.numpy(), np.asarray(want_off))
    for name, g, w in zip(("f", "b"), got, want):
        w = np.asarray(w)
        assert np.abs(w).max() > 0, name
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-5 * np.abs(w).max(),
                                   err_msg=name)


def test_fuse_and_patch_adjoints_are_transposes(rng):
    """<F x, y> == <x, F^T y> for the fuse passes and the 3x3 patch
    extraction, with wrap-region rows included."""
    x = torch.from_numpy(rng.standard_normal((2, 20, 20)).astype(np.float32))
    y = torch.from_numpy(rng.standard_normal((2, 20, 20)).astype(np.float32))
    lhs = (ca.fuse_scores(x, 4) * y).sum()
    rhs = (x * ca.fuse_adjoint(y, 4)).sum()
    assert float(lhs) == pytest.approx(float(rhs), rel=1e-5)
    img = torch.from_numpy(rng.standard_normal((1, 5, 4, 3)).astype(np.float32))
    pat = torch.from_numpy(rng.standard_normal((1, 20, 27)).astype(np.float32))
    lhs = (ca.extract_patches(img, 3, 1).reshape(1, 20, 27) * pat).sum()
    rhs = (img * ca.patches_adjoint(pat, 5, 4, 3, 3)).sum()
    assert float(lhs) == pytest.approx(float(rhs), rel=1e-5)
