"""Port vs JAX package on the CPU: the training step and the training driver.

Both packages start from the same variables (drawn with numpy from a seed
in flax's shapes, carried into the port by utils/weights.py) and take one
`train_step` on the same synthetic batch: ngf=4, ndf=8, 64 x 64, batch 2,
float32, at lr=0 for each of gan_head_preupdate True/False x crop_d3
True/False, and at lr=2e-4 for the defaults. The JAX step runs its XLA
attention path, the port its plain attention versions.

What is compared, and the tolerances:
- all 13 losses, rtol 1e-4 (~60 float32 convs and an attention softmax
  between the batch and the losses, sums in other orders; seen <= 2e-6);
- the new spectral-norm vectors u, atol 1e-5 on unit vectors (one power
  iteration from the same weights);
- the discriminators' running statistics, atol 1e-5 on the mean and rtol
  1e-4 on the variance (flax's E[x^2] - E[x]^2 against a two-pass variance,
  after a generator forward);
- every parameter gradient, per tensor: the JAX step's gradient is read
  from its Adam state after one step (mu = (1 - beta1) g, exact in float),
  the port's from .grad. |got - want| <= 1e-3 * G + 1e-3 * |want|, G the
  largest gradient of that network: the discriminators' gradients inherit
  flax's one-pass BatchNorm variance (see test_torch_discriminator.py),
  the generator's pass back through them and through 40 convs;
- one step at lr=2e-4: Adam's first update is lr * g / (|g| + 1e-8), i.e.
  +-lr wherever |g| >> 1e-8. The deltas agree to atol 1e-3 * lr except
  where the gradient sits at its rounding floor, |g| <= 1e-5 * G in either
  package: there the sign of g is noise and the update may flip. The test
  counts and reports those elements and requires them to be under 0.5 %
  of each network's parameters.
"""

import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from healthivert_tpu.data.synthetic import SyntheticDataset
from healthivert_tpu.models import pix2pix as jpix
from healthivert_tpu.models.layers import Conv2dBlock as JaxConv2dBlock
from healthivert_tpu_torch.config.options import check_ported
from healthivert_tpu_torch.engine.train_loop import run_training
from healthivert_tpu_torch.models import pix2pix
from healthivert_tpu_torch.models.layers import Conv2dBlock, SNConv
from healthivert_tpu_torch.ops.attention_cuda import attention_v2, attention_v2_bwd
from healthivert_tpu_torch.utils.weights import flax_to_state_dict
from torch_port_fixtures import (
    NETS,
    check_deltas,
    check_grads,
    check_sn_and_stats,
    draw_jax_train_state,
    jax_adam_grads,
    jax_state_dicts,
)

SMALL = dict(ngf=4, ndf=8, image_size=64)
MODES = [(True, True), (False, True), (True, False), (False, False)]
MODE_IDS = ["preupdate-crop", "postupdate-crop", "preupdate-full", "postupdate-full"]
LR = 2e-4


def _batch(bs=2, seed=0):
    ds = SyntheticDataset(batch_size=bs, seed=seed, shape=(64, 64, 16),
                          vert_ids=(19, 20), vert_height=14, gap=8)
    return {k: np.asarray(v) for k, v in ds.sample_batch().items()}


@functools.lru_cache(maxsize=None)
def _jax_step(preupdate, crop, lr):
    jcfg = jpix.Pix2PixConfig(**SMALL, gan_head_preupdate=preupdate, crop_d3=crop)
    batch = {k: jnp.asarray(v) for k, v in _batch().items()}
    new, losses = jpix.train_step(draw_jax_train_state(jcfg), batch, jnp.float32(lr), jcfg)
    return ({k: float(v) for k, v in losses.items()}, jax_state_dicts(new), jax_adam_grads(new))


def _port_state(cfg):
    state = pix2pix.init_state(cfg, seed=0, device="cpu")
    sds = jax_state_dicts(draw_jax_train_state(jpix.Pix2PixConfig(**SMALL)))
    for net in NETS:
        getattr(state, "gen" if net == "g" else net).load_state_dict(sds[net])
    return state, sds


def _nets(state):
    return dict(zip(NETS, (state.gen, state.d1, state.d2, state.d3)))


@functools.lru_cache(maxsize=None)
def _port_step(preupdate, crop, lr, **switches):
    cfg = pix2pix.Pix2PixConfig(**SMALL, gan_head_preupdate=preupdate, crop_d3=crop, **switches)
    state, before = _port_state(cfg)
    batch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    state, losses = pix2pix.train_step(state, batch, lr, cfg)
    after = {n: {k: v.clone() for k, v in m.state_dict().items()}
             for n, m in _nets(state).items()}
    grads = {n: {k: p.grad.clone() for k, p in m.named_parameters()}
             for n, m in _nets(state).items()}
    return {k: float(v) for k, v in losses.items()}, before, after, grads, state.step


@pytest.mark.parametrize("preupdate,crop", MODES, ids=MODE_IDS)
def test_losses_sn_and_bn_state_at_lr0(preupdate, crop):
    want_l, want_sd, _ = _jax_step(preupdate, crop, 0.0)
    got_l, _, got_sd, _, step = _port_step(preupdate, crop, 0.0)
    assert step == 1
    assert set(got_l) == set(want_l) == {
        "G_GAN", "G_maskL1", "G_Dice", "coarse_Dice", "edge", "D_real_1", "D_fake_1",
        "D_real_2", "D_fake_2", "D_real_3", "D_fake_3", "h", "G_total"}
    for k, w in want_l.items():
        assert got_l[k] == pytest.approx(w, rel=1e-4), k
    assert sum(k.endswith(".u") for k in want_sd["g"]) == sum(
        isinstance(m, SNConv) for m in pix2pix.build_generator(
            pix2pix.Pix2PixConfig(**SMALL)).modules())
    check_sn_and_stats(got_sd, want_sd)


@pytest.mark.parametrize("preupdate,crop", MODES, ids=MODE_IDS)
def test_parameter_gradients_at_lr0(preupdate, crop):
    """Every G and D gradient tensor of the step, against the JAX step's
    own jax.grad / jax.vjp; lr=0 leaves every parameter where it was."""
    _, _, want = _jax_step(preupdate, crop, 0.0)
    _, before, after, got, _ = _port_step(preupdate, crop, 0.0)
    check_grads(got, want)
    for net in NETS:
        for k in want[net]:
            torch.testing.assert_close(after[net][k], before[net][k], rtol=0, atol=0)


def test_one_step_parameter_deltas_at_lr_2e4(capsys):
    want_l, want_sd, want_g = _jax_step(True, True, LR)
    got_l, before, after, got_g, _ = _port_step(True, True, LR)
    for k, w in want_l.items():
        assert got_l[k] == pytest.approx(w, rel=1e-4), k
    report = check_deltas(before, after, want_sd, got_g, want_g, LR)
    with capsys.disabled():
        print("\nupdates that differ where |g| sits at the rounding floor "
              "(elements, of parameters):", report)


@pytest.mark.parametrize("switch,crop,lr", [("remat", True, LR),
                                             ("vmap_discriminators", False, 0.0)])
def test_remat_and_vmap_discriminators_match_jax(switch, crop, lr):
    """The step's last two switches. The JAX package holds its remat step to
    its baseline step (tests/test_train_step.py:187, 1e-6) and its vmapped
    discriminator updates to the sequential ones (:122, 2e-5); here each
    port step with the switch is held to the JAX baseline step of its mode
    at the tolerances above (losses, u, running statistics and gradients;
    at lr=2e-4 the updates too; vmap_discriminators needs crop_d3 off), and
    is bit-equal to the port's own step without it."""
    want_l, want_sd, want_g = _jax_step(True, crop, lr)
    got_l, before, after, got_g, _ = _port_step(True, crop, lr, **{switch: True})
    for k, w in want_l.items():
        assert got_l[k] == pytest.approx(w, rel=1e-4), k
    check_sn_and_stats(after, want_sd)
    check_grads(got_g, want_g)
    if lr:
        check_deltas(before, after, want_sd, got_g, want_g, lr)
    base_l, _, base_after, base_g, _ = _port_step(True, crop, lr)
    assert got_l == base_l
    for net in NETS:
        for k, v in base_after[net].items():
            torch.testing.assert_close(after[net][k], v, rtol=0, atol=0)
        for k, v in base_g[net].items():
            torch.testing.assert_close(got_g[net][k], v, rtol=0, atol=0)


def test_crop_d3_rejects_vmap_discriminators():
    """The JAX package's ValueError, with its message (its pix2pix.py:445-447)."""
    cfg = pix2pix.Pix2PixConfig(**SMALL, crop_d3=True, vmap_discriminators=True)
    state, _ = _port_state(cfg)
    batch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    jcfg = jpix.Pix2PixConfig(**SMALL, crop_d3=True, vmap_discriminators=True)
    with pytest.raises(ValueError) as want:
        jpix.train_step(draw_jax_train_state(jcfg), {k: jnp.asarray(v) for k, v in batch.items()},
                        jnp.float32(LR), jcfg)
    with pytest.raises(ValueError) as got:
        pix2pix.train_step(state, batch, LR, cfg)
    assert str(got.value) == str(want.value)
    assert "incompatible" in str(got.value)


def test_bfloat16_step_runs():
    cfg = pix2pix.Pix2PixConfig(**SMALL, compute_dtype="bfloat16")
    state, before = _port_state(cfg)
    batch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    launches = (attention_v2.launches, attention_v2_bwd.launches)
    state, losses = pix2pix.train_step(state, batch, LR, cfg)
    assert all(np.isfinite(float(v)) for v in losses.values()), losses
    for net, m in _nets(state).items():
        assert all(p.dtype == torch.float32 for p in m.parameters())
        moved = [not torch.equal(v, before[net][k]) for k, v in m.state_dict().items()
                 if not k.endswith(".u")]
        assert all(moved), net
    assert (attention_v2.launches, attention_v2_bwd.launches) == launches  # CPU: plain


def test_spectral_norm_gradient_matches_flax(rng):
    """The gradient reaches the kernel through W / sigma and through the W
    in sigma = u_new . (W v), with u and v constants."""
    x = rng.standard_normal((2, 10, 10, 3)).astype(np.float32)
    jblock = JaxConv2dBlock(6, 3, 1, 1, 1, "elu")
    v = jblock.init(jax.random.PRNGKey(1), jnp.asarray(x))
    u = rng.standard_normal(6).astype(np.float32)
    sn = {"conv": {"u": u / np.linalg.norm(u)}}
    w_out = rng.standard_normal((2, 10, 10, 6)).astype(np.float32)
    want = jax.grad(lambda p: jnp.sum(
        jblock.apply({"params": p, "sn": sn}, jnp.asarray(x)) * w_out))(v["params"])
    block = Conv2dBlock(3, 6, 3, 1, 1)
    block.load_state_dict(flax_to_state_dict(v["params"], sn))
    out = block(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    (out * torch.from_numpy(w_out)).sum().backward()
    want_sd = flax_to_state_dict(want, {})
    np.testing.assert_allclose(block.conv.weight.grad.numpy(),
                               want_sd["conv.weight"].numpy(), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(block.conv.bias.grad.numpy(),
                               want_sd["conv.bias"].numpy(), rtol=1e-4, atol=1e-5)
    # a forward leaves u alone; power_iteration advances it
    u0 = block.conv.u.clone()
    torch.testing.assert_close(block.conv.u, u0, rtol=0, atol=0)
    block.conv.power_iteration()
    assert not torch.equal(block.conv.u, u0)


def _opt(**kw):
    base = dict(
        dataset_mode="synthetic", batch_size=2, seed=3, crop_size=64, ndf=8, lr=LR,
        beta1=0.5, gan_mode="vanilla", epoch_count=1, n_epochs=5, n_epochs_decay=5,
        lr_policy="linear", print_freq=2, compute_dtype="float32",
        name="run", save_latest_freq=5000, save_epoch_freq=5, save_by_iter=False,
    )
    base.update(kw)
    return types.SimpleNamespace(**base)


def test_run_training_on_the_cpu(capsys, tmp_path):
    steps = []
    state, cfg = run_training(_opt(checkpoints_dir=str(tmp_path)), max_steps=2, device="cpu",
                              on_step=lambda step, losses: steps.append(step))
    assert steps == [1, 2] and state.step == 2
    assert cfg.ngf == 16 and cfg.image_size == 64 and cfg.gan_head_preupdate
    out = capsys.readouterr().out
    assert "learning rate 0.0002000 for epoch 1" in out
    assert "final losses" in out and "G_GAN" in out


def test_run_training_stops_on_non_finite_losses(tmp_path):
    with pytest.raises(FloatingPointError):
        run_training(_opt(lr=1e30, beta1=0.0, checkpoints_dir=str(tmp_path)), max_steps=3,
                     device="cpu")


def test_unported_options_raise():
    """net_d='seg', a model mesh axis, remat, vmap_discriminators and a data
    mesh, which each raised until they were ported, are accepted; an
    lr_policy that neither package runs still raises."""
    assert pix2pix.Pix2PixConfig(net_d="seg").net_d == "seg"
    assert pix2pix.Pix2PixConfig(remat=True).remat
    assert pix2pix.Pix2PixConfig(vmap_discriminators=True).vmap_discriminators
    check_ported(_opt(mesh="data:2", isTrain=True))
    check_ported(_opt(mesh="data:2,model:2", isTrain=True))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        check_ported(_opt(lr_policy="exponential", isTrain=True))
