"""Port vs JAX package on the CPU: the v1 patch attention.

`attention_scores_paste_reference` is the port's CPU path of
`attention_scores_paste` and the v1 CUDA kernel's oracle on the card, so it
is held here against JAX `attention_scores_paste(interpret=True)` on patch
tensors built from feature maps as the JAX contextual attention builds
them. The gate's hole band sits at the top and at the bottom of the query
grid (the sigma+ wrap bug of the TPU kernels showed only with a bottom
band), and the foreground is scaled by 0.05 so that attention is soft:
with dense unscaled features out-of-hole queries are one-hot, and
agreement there would prove little. One case has an odd grid and width
(6 x 10, C=20: K=180, RC=320), which the TPU kernel pads to 128 lanes and
the port does not.

Tolerances. float32: atol 2e-5 on the patch values, which are sums of L
products of probabilities and raw values of order 1, taken in another
order on each side. bfloat16: both sides sum in float32 and round the
result to bf16, and equal float32 sums can straddle a rounding boundary,
so two bf16 ulps (|d| <= 1e-3 + 1.6e-2 |want|).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import healthivert_tpu.ops.attention_pallas as ap
from healthivert_tpu_torch.ops.attention_cuda import (
    attention_scores_paste,
    attention_scores_paste_reference,
    attention_v2_reference,
    v1_fold,
    v1_patches,
)
from healthivert_tpu_torch.ops.contextual_attention import fuse_scores

BAND_ROWS = {"top": lambda hd: slice(0, hd // 3), "bottom": lambda hd: slice(hd - hd // 3, hd)}


def _case(b, hd, wd, c, band, seed=0):
    """Patch tensors (fpat, wnorm, raw) in float32 and the gate, as numpy."""
    rng = np.random.default_rng(seed)
    fd = rng.standard_normal((b, hd, wd, c)).astype(np.float32) * 0.05
    bd = rng.standard_normal((b, hd, wd, c)).astype(np.float32)
    b_full = rng.standard_normal((b, 2 * hd, 2 * wd, c)).astype(np.float32)
    g = np.ones((b, hd, wd), np.float32)
    g[:, BAND_ROWS[band](hd)] = 0.0
    patches = v1_patches(*map(torch.from_numpy, (fd, bd, b_full)))
    return [p.numpy() for p in patches] + [g.reshape(b, -1)]


@functools.lru_cache(maxsize=None)
def _both(b, hd, wd, c, band, dtype):
    fpat, wnorm, raw, mm = _case(b, hd, wd, c, band)
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    want = ap.attention_scores_paste(
        *(jnp.asarray(a, jdt) for a in (fpat, wnorm, raw)), jnp.asarray(mm), hd, wd, 10.0,
        interpret=True,
    )
    got = attention_scores_paste_reference(
        *(torch.from_numpy(a).to(tdt) for a in (fpat, wnorm, raw)), torch.from_numpy(mm),
        hd, wd, 10.0,
    )
    return np.asarray(want.astype(jnp.float32)), got, (fpat, wnorm, mm)


def _probs(fpat, wnorm, mm, wd):
    s = torch.einsum("blk,bpk->blp", torch.from_numpy(wnorm), torch.from_numpy(fpat))
    g = torch.from_numpy(mm)[:, :, None]
    return torch.softmax(fuse_scores(s, wd) * g * 10.0, dim=1) * g


@pytest.mark.parametrize("case", [(2, 16, 16, 4, "top"), (2, 16, 16, 4, "bottom"),
                                  (1, 6, 10, 20, "bottom")],
                         ids=lambda c: "x".join(map(str, c[:4])) + "_" + c[4])
def test_reference_matches_pallas_interpret(case):
    b, hd, wd, c, band = case
    want, got, (fpat, wnorm, mm) = _both(b, hd, wd, c, band, "float32")
    assert got.dtype == torch.float32 and got.shape == (b, hd * wd, 16 * c)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=0)
    # soft attention: the comparison is not of one-hot columns only
    assert float(_probs(fpat, wnorm, mm, wd).amax(dim=1).min()) < 0.9


def test_reference_matches_pallas_interpret_bf16():
    want, got, _ = _both(2, 16, 16, 4, "bottom", "bfloat16")
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=1e-3, rtol=1.6e-2)


def test_v1_folds_to_the_v2_forward():
    """v1 on patches and v2 on feature maps compute one forward: the v1
    values, folded, equal the v2 plain version's y (float32)."""
    rng = np.random.default_rng(3)
    fd, bd = (torch.from_numpy(rng.standard_normal((2, 8, 8, 4)).astype(np.float32))
              for _ in range(2))
    b_full = torch.from_numpy(rng.standard_normal((2, 16, 16, 4)).astype(np.float32))
    mm = torch.from_numpy((rng.random((2, 64)) > 0.3).astype(np.float32))
    vals = attention_scores_paste(*v1_patches(fd * 0.05, bd, b_full), mm, 8, 8)
    y = attention_v2_reference(fd * 0.05, bd, b_full, mm, 8, 8)
    torch.testing.assert_close(v1_fold(vals, 8, 8), y, atol=2e-5, rtol=0)


def test_wrapper_runs_the_plain_version_on_cpu():
    fpat, wnorm, raw, mm = map(torch.from_numpy, _case(1, 6, 10, 20, "top"))
    before = attention_scores_paste.launches
    got = attention_scores_paste(fpat, wnorm, raw, mm, 6, 10)
    torch.testing.assert_close(got, attention_scores_paste_reference(fpat, wnorm, raw, mm, 6, 10))
    assert attention_scores_paste.launches == before  # launches count the kernel only
