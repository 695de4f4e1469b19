"""Port vs JAX package on the CPU: discriminators, GAN losses, BatchNorm
statistics, the initialisers, dice_coeff, band_crop_batch and the
learning-rate schedule.

The same numpy inputs from a seed go through both; the discriminator
weights are the flax initialisation carried over by utils/weights.py.

Tolerances. float32 discriminator logits: atol 2e-5 on logits ~1 (XLA and
oneDNN sum up to 4*4*64 products in different orders). Parameter gradients
of the discriminator loss, per tensor: |got - want| <= 1e-3 * G + 1e-4 *
|want|, G the largest gradient of the network. The backward through
BatchNorm cancels terms far larger than its result, and flax computes the
variance as E[x^2] - E[x]^2: for the pixel discriminator under wgangp the
JAX gradient of the first conv's bias is off by ~1e-3 G from a float64
evaluation, the port's by ~2e-5 G.
Running statistics after two forwards: atol 1e-6 on the mean and rtol
1e-5 on the variance (flax computes E[x^2] - E[x]^2, torch a two-pass
variance). dice_coeff, band_crop and the schedule: float32 rounding only,
or exact.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from healthivert_tpu.models import discriminator as jdisc
from healthivert_tpu.models import pix2pix as jpix
from healthivert_tpu.ops import geometry as jgeo
from healthivert_tpu.ops import image as jimage
from healthivert_tpu_torch.models import discriminator as disc
from healthivert_tpu_torch.models import pix2pix
from healthivert_tpu_torch.models.layers import weight_init
from healthivert_tpu_torch.ops import geometry, image
from healthivert_tpu_torch.utils.weights import flax_discriminator_to_state_dict

# (net_d, norm, n_layers): the shipped recipe, the config-matrix corners
CASES = [("basic", "batch", 3), ("n_layers", "batch", 2), ("pixel", "batch", 1),
         ("basic", "instance", 3), ("n_layers", "none", 2)]


def _pair(net_d, norm, n_layers, seed=0, ndf=8):
    """(flax module, its variables, the port's module with them)."""
    jcfg = jpix.Pix2PixConfig(ndf=ndf, net_d=net_d, norm=norm, n_layers_d=n_layers)
    jd = jpix.build_modules(jcfg)[1]
    x = jnp.zeros((2, 40, 48, 1))
    v = jd.init(jax.random.PRNGKey(seed), x, train=True)
    # running statistics that are not the init's, so the update is tested
    rng = np.random.default_rng(seed)
    stats = jax.tree_util.tree_map(
        lambda a: (rng.uniform(0.5, 1.5, a.shape) if a.ndim else a).astype(np.float32),
        v.get("batch_stats", {}),
    )
    v = {"params": v["params"], "batch_stats": stats}
    cfg = pix2pix.Pix2PixConfig(ndf=ndf, net_d=net_d, norm=norm, n_layers_d=n_layers)
    d = pix2pix.build_discriminator(cfg)
    d.load_state_dict(flax_discriminator_to_state_dict(v["params"], v["batch_stats"]))
    return jd, v, d


def _images(rng, n=2, h=40, w=48):
    return [rng.standard_normal((n, h, w, 1)).astype(np.float32) for _ in range(2)]


@pytest.mark.parametrize("net_d,norm,n_layers", CASES)
def test_logits_and_running_stats_after_two_forwards(rng, net_d, norm, n_layers):
    """fake then real, the stats threaded from the first forward to the
    second, as the discriminator update runs them."""
    jd, v, d = _pair(net_d, norm, n_layers)
    fake, real = _images(rng)
    lf, mut = jd.apply(v, jnp.asarray(fake), train=True, mutable=["batch_stats"])
    v2 = {"params": v["params"], "batch_stats": mut.get("batch_stats", {})}
    lr_, mut = jd.apply(v2, jnp.asarray(real), train=True, mutable=["batch_stats"])
    with torch.no_grad():
        gf = d(torch.from_numpy(fake))
        gr = d(torch.from_numpy(real))
    np.testing.assert_allclose(gf.numpy(), np.asarray(lf), atol=2e-5, rtol=0)
    np.testing.assert_allclose(gr.numpy(), np.asarray(lr_), atol=2e-5, rtol=0)
    want = flax_discriminator_to_state_dict({}, mut.get("batch_stats", {}))
    got = d.state_dict()
    for key, w in want.items():
        if key.endswith("running_mean"):
            np.testing.assert_allclose(got[key].numpy(), w.numpy(), atol=1e-6, rtol=0)
        else:
            np.testing.assert_allclose(got[key].numpy(), w.numpy(), rtol=1e-5, atol=0)
    assert (len(want) > 0) == (norm == "batch")


def test_update_stats_false_leaves_running_stats(rng):
    _, _, d = _pair("basic", "batch", 3)
    before = {k: v.clone() for k, v in d.state_dict().items()}
    with torch.no_grad():
        d(torch.from_numpy(_images(rng)[0]), update_stats=False)
    for k, v in d.state_dict().items():
        torch.testing.assert_close(v, before[k], rtol=0, atol=0)


@pytest.mark.parametrize("gan_mode", ["vanilla", "lsgan", "wgangp"])
@pytest.mark.parametrize("net_d,norm,n_layers", CASES[:3])
def test_discriminator_loss_gradients(rng, net_d, norm, n_layers, gan_mode):
    """The discriminator update's loss, (gan(D(fake), 0) + gan(D(real), 1))
    / 2 over two forwards, and its gradient per parameter tensor."""
    jd, v, d = _pair(net_d, norm, n_layers)
    fake, real = _images(rng)

    def loss_fn(params):
        st = v["batch_stats"]
        lf, mut = jd.apply({"params": params, "batch_stats": st}, jnp.asarray(fake),
                           train=True, mutable=["batch_stats"])
        lr_, _ = jd.apply({"params": params, "batch_stats": mut["batch_stats"]},
                          jnp.asarray(real), train=True, mutable=["batch_stats"])
        return (jdisc.gan_loss(lf, False, gan_mode) + jdisc.gan_loss(lr_, True, gan_mode)) * 0.5

    want_l, want_g = jax.value_and_grad(loss_fn)(v["params"])
    got_l = (disc.gan_loss(d(torch.from_numpy(fake)), False, gan_mode)
             + disc.gan_loss(d(torch.from_numpy(real)), True, gan_mode)) * 0.5
    got_l.backward()
    assert float(got_l.detach()) == pytest.approx(float(want_l), rel=1e-5, abs=1e-6)
    want = flax_discriminator_to_state_dict(want_g)
    params = dict(d.named_parameters())
    assert set(want) == set(params)
    scale = max(float(np.abs(w.numpy()).max()) for w in want.values())
    for name, w in want.items():
        g, w = params[name].grad.numpy(), w.numpy()
        tol = 1e-3 * scale + 1e-4 * np.abs(w)
        assert np.all(np.abs(g - w) <= tol), (name, np.abs(g - w).max(), np.abs(w).max())


def test_gan_loss_matches_jax(rng):
    x = rng.standard_normal((2, 5, 5, 1)).astype(np.float32) * 3
    for mode in ("vanilla", "lsgan", "wgangp"):
        for real in (True, False):
            want = float(jdisc.gan_loss(jnp.asarray(x), real, mode))
            got = float(disc.gan_loss(torch.from_numpy(x), real, mode))
            assert got == pytest.approx(want, rel=1e-6, abs=1e-7), (mode, real)
    with pytest.raises(ValueError):
        disc.gan_loss(torch.zeros(1), True, "hinge")


@pytest.mark.parametrize("init_type", ["normal", "xavier", "kaiming", "orthogonal"])
def test_weight_init_distributions(init_type):
    """Same distributions as the JAX package's initialisers (the numbers
    differ: jax.random and torch.Generator are different streams)."""
    w = torch.empty(256, 64, 4, 4)
    weight_init(w, torch.Generator().manual_seed(0), init_type, 0.02)
    fan_in, fan_out = 64 * 16, 256 * 16
    if init_type == "orthogonal":
        mat = w.permute(2, 3, 1, 0).reshape(-1, 256)  # flax's (kh kw in, out)
        torch.testing.assert_close(mat.T @ mat, 0.02**2 * torch.eye(256), rtol=0, atol=1e-6)
        return
    want = {"normal": 0.02, "xavier": 0.02 * (2 / (fan_in + fan_out)) ** 0.5,
            "kaiming": (2 / fan_in) ** 0.5}[init_type]
    assert float(w.std()) == pytest.approx(want, rel=0.02)
    assert abs(float(w.mean())) < 0.02 * want


def test_discriminator_init_is_seeded():
    a = disc.NLayerDiscriminator(ndf=8).init_weights(torch.Generator().manual_seed(3))
    b = disc.NLayerDiscriminator(ndf=8).init_weights(torch.Generator().manual_seed(3))
    for (k, x), (_, y) in zip(a.state_dict().items(), b.state_dict().items()):
        torch.testing.assert_close(x, y, rtol=0, atol=0, msg=k)
    assert float(a.norm1.weight.detach().mean()) == pytest.approx(1.0, abs=0.02)
    assert float(a.norm1.running_var.min()) == 1.0


def test_dice_coeff(rng):
    pred = rng.random((3, 16, 12, 1)).astype(np.float32)
    gt = (rng.random((3, 16, 12, 1)) > 0.6).astype(np.float32)
    gt[2] = 0.0  # an empty target: eps keeps it finite
    want = float(jimage.dice_coeff(jnp.asarray(pred), jnp.asarray(gt)))
    got = float(image.dice_coeff(torch.from_numpy(pred), torch.from_numpy(gt)))
    assert got == pytest.approx(want, rel=1e-6)


def test_band_crop_batch_matches_jax_and_is_differentiable(rng):
    h, w = 96, 160
    img = rng.standard_normal((5, h, w, 1)).astype(np.float32)
    mask = np.zeros((5, h, w, 1), np.float32)
    for i, r0 in enumerate((0, 2, 40, h - 41)):  # top, near top, middle, bottom
        mask[i, r0 : r0 + 41] = 1.0
    # sample 4: empty mask, the crop starts at row 0
    want = np.asarray(jgeo.band_crop_batch(jnp.asarray(img), jnp.asarray(mask), 48, 128))
    x = torch.from_numpy(img).requires_grad_(True)
    got = geometry.band_crop_batch(x, torch.from_numpy(mask), 48, 128)
    np.testing.assert_array_equal(got.detach().numpy(), want)
    one = geometry.band_crop(torch.from_numpy(img[2]), torch.from_numpy(mask[2]), 48, 128)
    np.testing.assert_array_equal(one.numpy(), want[2])
    got.sum().backward()
    # the gradient is the indicator of the cropped window
    assert float(x.grad.sum()) == 5 * 48 * 128
    assert set(np.unique(x.grad.numpy())) == {0.0, 1.0}


def _schedules(policy, **kw):
    base = dict(lr_policy=policy, lr=2e-4, epoch_count=1, n_epochs=10, n_epochs_decay=10,
                lr_decay_iters=5)
    base.update(kw)
    opt = types.SimpleNamespace(**base)
    return jpix.LRSchedule(opt), pix2pix.LRSchedule(opt)


@pytest.mark.parametrize("policy,kw", [
    ("linear", {}), ("linear", {"epoch_count": 15}), ("step", {}), ("cosine", {}),
    ("plateau", {}),
], ids=["linear", "linear_resumed", "step", "cosine", "plateau"])
def test_lr_schedule_matches_jax(policy, kw):
    want, got = _schedules(policy, **kw)
    metrics = [1.0, 0.9, 0.95, 0.95, 0.95, 0.95, 0.95, 0.95, 0.95, 0.5] * 2
    for epoch, m in zip(range(kw.get("epoch_count", 1), 21), metrics):
        metric = m if policy == "plateau" else None
        assert got.scale(epoch, metric) == want.scale(epoch, metric), (policy, epoch)
    assert pix2pix.linear_lr_scale(5, 1, 10, 10) == jpix.linear_lr_scale(5, 1, 10, 10)
    with pytest.raises(NotImplementedError):
        pix2pix.LRSchedule(types.SimpleNamespace(lr_policy="exp")).scale(1)
