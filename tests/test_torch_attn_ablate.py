"""Port vs JAX package on the CPU: the forward's stage ablation.

The JAX package's experiments/attn_ablate.py runs its Pallas kernels with no
`interpret` switch, so a fixture here patches
`jax.experimental.pallas.pallas_call` to add `interpret=True` before any of
them is traced; `run` and its siblings are jitted, and a trace without the
patch would pin the TPU variant in their compile cache.
tests/test_torch_attn_ablate_tc.py, the only other file that calls them,
patches it the same way. Importing that module also points JAX's
persistent compile cache at a directory of its own; the import here puts
the setting back.

Each of the port's entry functions (`run`, `run_padded`, `run_auto`,
`run_fold`) runs its plain version on a CPU tensor and is held against the
JAX function of the same name in float32: `run` in every mode at (2, 16, 16,
4), the first sample's hole band at the top of the query grid and the
second's at the bottom, with soft attention (fd scaled by 0.05);
`run_padded` at C=64, the JAX function's c_real, on an 8 x 8 grid;
`run_auto` and `run_fold` in full and floor, as the JAX main runs them.

Tolerances (the same float32 arithmetic, sums in another order):
- full, no_score, no_fuse, fold_norm: atol 2e-5 on outputs of order 1 that
  are sums of 4 L products (seen 3.6e-6);
- no_softmax: the fused scores paste without exp or gate and outputs reach
  ~16 here, so 1e-5 of the largest output (seen 1.8e-7 of it);
- paste_bf16: both sides round float32 probabilities to bf16, and equal
  float32 values computed in another order can straddle a rounding
  boundary; one straddle moves an output by one bf16 ulp of that
  probability (at most 2^-7 of it) times a raw value, / 4. Allowed: two
  such straddles at the largest probability and raw value, plus 2e-5;
- no_paste and floor: exactly zero on both sides.
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


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    orig = jpl.pallas_call
    monkeypatch.setattr(jpl, "pallas_call",
                        lambda *a, **k: orig(*a, **{**k, "interpret": True}))


def _inputs(b, hd, wd, c, seed=0):
    rng = np.random.default_rng(seed)
    fd = rng.standard_normal((b, hd, wd, c)).astype(np.float32) * 0.05
    bd = rng.standard_normal((b, hd, wd, c)).astype(np.float32)
    b_full = rng.standard_normal((b, 2 * hd, 2 * wd, c)).astype(np.float32)
    g = np.ones((b, hd, wd), np.float32)
    g[0, : hd // 3] = 0.0  # band at the top
    g[-1, hd - hd // 3 :] = 0.0  # band at the bottom
    return fd, bd, b_full, g.reshape(b, -1)


CASE = (2, 16, 16, 4)


@functools.lru_cache(maxsize=None)
def _both(name, mode, case=CASE):
    b, hd, wd, c = case
    fd, bd, b_full, mm = _inputs(*case)
    third = b_full
    if name == "run_padded":
        third = b_full.reshape(b, hd, 2, wd, 2, c).transpose(0, 2, 4, 1, 3, 5).copy()
    want = getattr(jab, name)(*map(jnp.asarray, (fd, bd, third, mm)), hd, wd, mode=mode)
    got = getattr(tab, name)(*map(torch.from_numpy, (fd, bd, third, mm)), hd, wd, mode=mode)
    return np.asarray(want), got.numpy(), (fd, bd, b_full, mm)


def _assert_mode_close(mode, got, want, inputs):
    if mode in ("no_paste", "floor"):
        np.testing.assert_array_equal(want, 0.0)
        np.testing.assert_array_equal(got, 0.0)
        return
    atol = 2e-5
    if mode == "no_softmax":
        atol = 1e-5 * float(np.abs(want).max())
    elif mode == "paste_bf16":
        fd, bd, b_full, mm = inputs
        hd, wd = fd.shape[1:3]
        probs = _full_probs(fd, bd, mm, wd)
        atol += 2 * 2.0**-7 * float(probs.max()) * float(np.abs(b_full).max()) / 4
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)


def _full_probs(fd, bd, mm, wd):
    from healthivert_tpu_torch.ops.attention_cuda import attention_v2_reference

    hd = fd.shape[1]
    b_full = torch.zeros((fd.shape[0], 2 * hd, 2 * wd, fd.shape[-1]))
    _, _, probs, _ = attention_v2_reference(torch.from_numpy(fd), torch.from_numpy(bd), b_full,
                                            torch.from_numpy(mm), hd, wd, 10.0, True)
    return probs.numpy()


@pytest.mark.parametrize("mode", tab.MODES)
def test_run_matches_jax(mode):
    want, got, inputs = _both("run", mode)
    assert got.shape == want.shape == inputs[2].shape and got.dtype == np.float32
    _assert_mode_close(mode, got, want, inputs)
    if mode == "no_softmax":  # unnormalised, ungated: far from the softmax's range
        assert np.abs(want).max() > 4.0


@pytest.mark.parametrize("mode", ["full", "floor"])
def test_run_padded_matches_jax(mode):
    want, got, inputs = _both("run_padded", mode, (2, 8, 8, 64))
    assert got.shape == want.shape == (2, 2, 2, 8, 8, 64)
    _assert_mode_close(mode, got, want, inputs)


@pytest.mark.parametrize("mode", ["full", "floor"])
@pytest.mark.parametrize("name", ["run_auto", "run_fold"])
def test_run_auto_and_fold_match_jax(name, mode):
    want, got, inputs = _both(name, mode)
    assert got.shape == want.shape == inputs[2].shape
    _assert_mode_close(mode, got, want, inputs)


def test_attention_is_soft_and_bands_reach_both_ends():
    fd, bd, _, mm = _inputs(*CASE)
    probs = _full_probs(fd, bd, mm, CASE[2])
    assert probs.max(axis=1).min() < 0.9
    g = mm.reshape(CASE[:3])
    assert g[0, 0].max() == 0.0 and g[-1, -1].max() == 0.0


def test_fold_norm_plain_equals_full():
    """1/sum scales each probs column p before the paste, so fold_norm is
    full in another order (float32)."""
    fd, bd, b_full, mm = map(torch.from_numpy, _inputs(*CASE))
    ys = [tab.ablate_reference(fd, bd, b_full, mm, 16, 16, mode=m) for m in ("full", "fold_norm")]
    torch.testing.assert_close(ys[1], ys[0], atol=1e-6, rtol=0)


def test_phase_planes_match_the_jax_wrapper():
    fd, bd, b_full, mm = _inputs(*CASE)
    bph = tab.to_phases(torch.from_numpy(b_full), 16, 16)
    want = b_full.reshape(2, 16, 2, 16, 2, 4).transpose(0, 2, 4, 1, 3, 5)
    np.testing.assert_array_equal(bph.numpy(), want)
    np.testing.assert_array_equal(tab.from_phases(bph).numpy(), b_full)


def test_wrappers_run_the_plain_version_on_cpu():
    fd, bd, b_full, mm = map(torch.from_numpy, _inputs(1, 6, 10, 20))
    fns = (tab.run, tab.run_padded, tab.run_auto, tab.run_fold)
    before = [f.launches for f in fns]
    want = tab.ablate_reference(fd, bd, b_full, mm, 6, 10, mode="fold_norm")
    for f in fns:
        third = tab.to_phases(b_full, 6, 10) if f is tab.run_padded else b_full
        got = f(fd, bd, third, mm, 6, 10, mode="fold_norm")
        if f is tab.run_padded:
            got = tab.from_phases(got)
        torch.testing.assert_close(got, want)
    assert [f.launches for f in fns] == before  # launches count the kernel only
    with pytest.raises(ValueError):
        tab.run(fd, bd, b_full, mm, 6, 10, mode="no_such_mode")


def test_main_prints_every_line_on_cpu(monkeypatch, capsys):
    """The entry point on the CPU (plain versions) at a small grid: every
    mode and variant timed, `full`'s variants equal to it, one JSON line."""
    import json

    monkeypatch.setattr(tab, "GRID", 8)
    monkeypatch.setattr(tab, "CHANNELS", 4)
    monkeypatch.setattr(tab, "REPS", 1)
    out = tab.main(["2", "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert json.loads(lines[-1]) == {"ablation": out}
    assert out["device"] == "cpu" and out["grid"] == [8, 8] and out["dtype"] == "bfloat16"
    want = set(tab.MODES) | {f"{v}-{m}" for v in ("padded", "auto", "fold")
                             for m in ("full", "floor")} | {"v1", "v1-route"}
    assert set(out["ms"]) == want
    errs = out["rel_err_vs_full"]
    assert errs["auto-full"] == 0.0 and errs["fold-full"] == 0.0
    # bf16 outputs: the candidates within two bf16 ulps of the largest output
    assert errs["fold_norm"] <= 1.6e-2 and errs["paste_bf16"] <= 1.6e-2
