"""Port vs JAX package on the CPU: the legacy networks (models/legacy.py)
and --netD seg training.

Both packages get the same variables (drawn with numpy from a seed in
flax's shapes, carried into the port by utils/weights.flax_legacy_to_state_dict)
and the same inputs, at ndf 8 / ngf 4-8, 32 x 32 or 64 x 64, batch 2.

What is compared, and the tolerances:
- SegDiscriminator: the patch logits and the seg map at the JAX shapes
  (a 64 x 64 input gives 6 x 6 logits and a 48 x 48 map), atol 1e-5, in
  training and eval mode; the running statistics a training forward leaves,
  atol 1e-5 on the mean and rtol 1e-4 on the variance;
- UnetGenerator, ResnetGenerator and DualHeadUNet in training and eval
  mode: within 1e-4 of the largest |output| (a dozen float32 convs and
  BatchNorms, sums in other orders), running statistics as above;
- gradient_penalty through a PatchGAN with the JAX draw of alpha passed in,
  rtol 1e-4 (a gradient through the discriminator);
- one train_step at net_d="seg" against the JAX step at lr 0 with the
  checks of tests/test_torch_train_step.py (losses rtol 1e-4, gradients and
  BatchNorm state as torch_port_fixtures.check_grads and
  check_sn_and_stats); the bf16 step's discriminator output is float32;
- the initialisers: the distributions of the JAX modules' (the draws
  differ).
"""

import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from healthivert_tpu.data.synthetic import SyntheticDataset
from healthivert_tpu.models import legacy as jl
from healthivert_tpu.models import pix2pix as jpix
from healthivert_tpu.models.discriminator import NLayerDiscriminator as JaxD
from healthivert_tpu_torch.engine import checkpoint as ckpt
from healthivert_tpu_torch.engine.train_loop import config_from_opt
from healthivert_tpu_torch.models import legacy, pix2pix
from healthivert_tpu_torch.models.discriminator import BatchNorm, NLayerDiscriminator
from healthivert_tpu_torch.utils.weights import (
    flax_discriminator_to_state_dict,
    flax_legacy_to_state_dict,
)
from torch_port_fixtures import (
    NETS,
    check_grads,
    check_sn_and_stats,
    draw_jax_train_state,
    jax_adam_grads,
    jax_state_dicts,
)
from torch_port_fixtures import one_torch_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SMALL = dict(ngf=4, ndf=8, image_size=64, net_d="seg")


def _draw(variables, seed=0):
    """The flax variables' shapes, drawn with numpy: kernels N(0, 0.1),
    scales N(1, 0.1), small biases and means, variances in [0.5, 1.5]."""
    rng = np.random.default_rng(seed)

    def f(path, a):
        k = path[-1].key
        shape = np.shape(a)
        if k == "kernel":
            return (0.1 * rng.standard_normal(shape)).astype(np.float32)
        if k == "scale":
            return (1 + 0.1 * rng.standard_normal(shape)).astype(np.float32)
        if k == "var":
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        return (0.1 * rng.standard_normal(shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(f, variables)


def _run_both(jmod, tmod, x, train):
    """Outputs (tuples) and post-forward state dicts of both packages."""
    shapes = jax.eval_shape(functools.partial(jmod.init, train=True),
                            jax.random.PRNGKey(0), jnp.asarray(x))
    v = _draw(shapes)
    apply = jax.jit(functools.partial(jmod.apply, train=train, mutable=["batch_stats"]))
    out, mut = apply(v, jnp.asarray(x))
    tmod.load_state_dict(flax_legacy_to_state_dict(v["params"], v["batch_stats"]))
    tmod.train(train)
    with torch.no_grad():
        got = tmod(torch.from_numpy(x))
    want_sd = flax_legacy_to_state_dict(v["params"], mut["batch_stats"])
    as_tuple = lambda o: o if isinstance(o, tuple) else (o,)
    return ([np.asarray(o) for o in as_tuple(out)], [g.numpy() for g in as_tuple(got)],
            want_sd, tmod.state_dict())


def _check_stats(got_sd, want_sd):
    stats = [k for k in want_sd if ".running_" in k]
    assert stats
    for k in stats:
        w, g = want_sd[k].numpy(), got_sd[k].numpy()
        if k.endswith("running_mean"):
            np.testing.assert_allclose(g, w, atol=1e-5, rtol=0, err_msg=k)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=0, err_msg=k)


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_seg_discriminator_matches_jax(rng, train):
    x = rng.standard_normal((2, 64, 64, 1)).astype(np.float32)
    want, got, want_sd, got_sd = _run_both(
        jl.SegDiscriminator(ndf=8, n_layers=3), legacy.SegDiscriminator(1, 8, 3), x, train)
    assert [w.shape for w in want] == [(2, 6, 6, 1), (2, 48, 48, 1)]
    for w, g in zip(want, got):
        assert g.shape == w.shape and g.dtype == np.float32
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=0)
    if train:
        _check_stats(got_sd, want_sd)
    else:
        for k, v in want_sd.items():  # eval mode leaves the statistics alone
            torch.testing.assert_close(got_sd[k], v, rtol=0, atol=0)


def test_seg_logits_alone_update_the_decoder_statistics(rng):
    """seg=False (the train step's call) gives the same logits and leaves
    the same running statistics as the full forward, and no graph reaches
    the decoder; with update_stats=False the statistics stay."""
    x = torch.from_numpy(rng.standard_normal((2, 64, 64, 1)).astype(np.float32))
    d = legacy.SegDiscriminator(1, 8, 3).init_weights(torch.Generator().manual_seed(0))
    twin = legacy.SegDiscriminator(1, 8, 3)
    twin.load_state_dict(d.state_dict())
    logits = d(x, seg=False)
    want, _ = twin(x)
    torch.testing.assert_close(logits, want, rtol=0, atol=0)
    for k, v in twin.state_dict().items():
        torch.testing.assert_close(d.state_dict()[k], v, rtol=0, atol=0)
    logits.sum().backward()
    assert d.dec1.weight.grad is None and d.enc1_conv.weight.grad is not None
    before = {k: v.clone() for k, v in d.state_dict().items()}
    d(x, update_stats=False, seg=False)
    for k, v in before.items():
        torch.testing.assert_close(d.state_dict()[k], v, rtol=0, atol=0)


NETWORKS = {
    "unet": (lambda: jl.UnetGenerator(num_downs=5, ngf=8),
             lambda: legacy.UnetGenerator(1, 1, 5, 8), 32),
    "resnet": (lambda: jl.ResnetGenerator(ngf=4, n_blocks=2),
               lambda: legacy.ResnetGenerator(1, 1, 4, 2), 32),
    "dualhead": (lambda: jl.DualHeadUNet(num_downs=4, ngf=8),
                 lambda: legacy.DualHeadUNet(1, 1, 4, 8), 32),
}


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("name", sorted(NETWORKS))
def test_legacy_generators_match_jax(rng, name, train):
    jmake, tmake, size = NETWORKS[name]
    x = rng.standard_normal((2, size, size, 1)).astype(np.float32)
    want, got, want_sd, got_sd = _run_both(jmake(), tmake(), x, train)
    assert len(got) == len(want) == (2 if name == "dualhead" else 1)
    for w, g in zip(want, got):
        assert g.shape == w.shape == (2, size, size, 1)
        np.testing.assert_allclose(g, w, atol=1e-4 * float(np.abs(w).max()), rtol=0)
    if train:
        _check_stats(got_sd, want_sd)


def test_resnet_same_transposed_conv_pads():
    """'SAME' at k 3, stride 2 is lax's (2, 1): the port crops the high
    side its transposed conv cannot pad less."""
    assert legacy.same_pads(3, 2) == (2, 1)
    assert legacy.same_pads(4, 2) == (2, 2)
    x = torch.randn(1, 3, 5, 7)
    up = legacy.ConvTranspose(3, 2, 3, 2, "SAME")
    up.init_weight(torch.Generator().manual_seed(0), "normal", 0.5)
    assert up(x).shape == (1, 2, 10, 14)


def test_gradient_penalty_matches_jax(rng):
    real = rng.standard_normal((2, 32, 32, 1)).astype(np.float32)
    fake = rng.standard_normal((2, 32, 32, 1)).astype(np.float32)
    jd = JaxD(ndf=8, n_layers=3)
    shapes = jax.eval_shape(functools.partial(jd.init, train=True), jax.random.PRNGKey(0),
                            jnp.asarray(real))
    v = _draw(shapes)
    key = jax.random.PRNGKey(3)

    def jdisc(x):
        return jd.apply(v, x, train=True, mutable=["batch_stats"])[0]

    want = float(jax.jit(lambda r, f: jl.gradient_penalty(jdisc, r, f, key))(
        jnp.asarray(real), jnp.asarray(fake)))
    alpha = np.array(jax.random.uniform(key, (2, 1, 1, 1)))
    d = NLayerDiscriminator(1, 8, 3)
    d.load_state_dict(flax_discriminator_to_state_dict(v["params"], v["batch_stats"]))
    got = legacy.gradient_penalty(d, torch.from_numpy(real), torch.from_numpy(fake),
                                  alpha=torch.from_numpy(alpha))
    assert float(got.detach()) == pytest.approx(want, rel=1e-4)
    # differentiable in D's weights; a drawn alpha comes from the generator
    got.backward()
    assert d.conv1.weight.grad is not None and float(d.conv1.weight.grad.abs().sum()) > 0
    drawn = [float(legacy.gradient_penalty(d, torch.from_numpy(real), torch.from_numpy(fake),
                                           generator=torch.Generator().manual_seed(5)))
             for _ in range(2)]
    assert drawn[0] == drawn[1]


def test_initialisers_follow_the_jax_modules():
    """Per layer, the JAX module's distributions: `_down`'s BatchNorm
    scales from N(1, gain), enc_final_bn's and dec<i>_bn's ones, biases
    zero; kaiming takes a conv's fan-in and a transposed conv's fan-out
    (tests/test_init_schemes.py:104 for the JAX UNet)."""
    g = torch.Generator().manual_seed(0)
    d = legacy.SegDiscriminator(1, 64, 3, init_type="normal", init_gain=0.2).init_weights(g)
    for name in ("enc1_bn", "enc2_bn"):
        s = getattr(d, name).weight
        assert abs(float(s.mean()) - 1.0) < 0.1 and 0.1 < float(s.std()) < 0.3
    for name in ("enc_final_bn", "dec1_bn", "dec2_bn", "dec3_bn"):
        assert torch.equal(getattr(d, name).weight, torch.ones_like(getattr(d, name).weight))
    assert float(d.enc1_conv.weight.std()) == pytest.approx(0.2, rel=0.05)
    assert float(d.dec1.weight.std()) == pytest.approx(0.2, rel=0.05)
    assert not d.dec1.bias.any() and not d.patch_out.bias.any()

    net = legacy.UnetGenerator(1, 1, 5, 8, init_type="kaiming").init_weights(g)
    k = net.down2_conv.weight  # OIHW
    assert float(k.std()) / np.sqrt(2.0 / (k.shape[1] * 16)) == pytest.approx(1.0, abs=0.15)
    up = net.up1_deconv.weight  # (in, out, kh, kw): fan-out = out kh kw
    assert float(up.std()) / np.sqrt(2.0 / (up.shape[1] * 16)) == pytest.approx(1.0, abs=0.15)
    r = legacy.ResnetGenerator(1, 1, 8, 2).init_weights(g)
    assert torch.equal(r.block0.bn1.weight, torch.ones(32))
    net = legacy.UnetGenerator(1, 1, 5, 8, init_type="orthogonal", init_gain=1.0).init_weights(g)
    w = net.up4_deconv.weight.flip(2, 3).permute(2, 3, 0, 1).reshape(-1, 1)
    assert float((w * w).sum()) == pytest.approx(1.0, rel=1e-5)  # a unit column


def _batch(bs=2, seed=0):
    ds = SyntheticDataset(batch_size=bs, seed=seed, shape=(64, 64, 16),
                          vert_ids=(19, 20), vert_height=14, gap=8)
    return {k: np.asarray(v) for k, v in ds.sample_batch().items()}


@functools.lru_cache(maxsize=None)
def _jax_seg_step():
    jcfg = jpix.Pix2PixConfig(**SMALL)
    js = draw_jax_train_state(jcfg)
    before = jax_state_dicts(js, legacy=True)
    batch = {k: jnp.asarray(v) for k, v in _batch().items()}
    new, losses = jpix.train_step(js, batch, jnp.float32(0.0), jcfg)
    return ({k: float(v) for k, v in losses.items()}, before,
            jax_state_dicts(new, legacy=True), jax_adam_grads(new, legacy=True))


def _port_state(cfg, sds):
    state = pix2pix.init_state(cfg, seed=0, device="cpu")
    for net in NETS:
        getattr(state, "gen" if net == "g" else net).load_state_dict(sds[net])
    return state


def _nets(state):
    return dict(zip(NETS, (state.gen, state.d1, state.d2, state.d3)))


def test_seg_train_step_matches_jax_at_lr0():
    want_l, before, want_sd, want_g = _jax_seg_step()
    cfg = pix2pix.Pix2PixConfig(**SMALL)
    state = _port_state(cfg, before)
    assert isinstance(state.d1, legacy.SegDiscriminator)
    state, losses = pix2pix.train_step(state, {k: torch.from_numpy(v) for k, v in
                                               _batch().items()}, 0.0, cfg)
    assert set(losses) == set(want_l)
    for k, w in want_l.items():
        assert float(losses[k]) == pytest.approx(w, rel=1e-4), k
    got_sd = {n: m.state_dict() for n, m in _nets(state).items()}
    check_sn_and_stats(got_sd, want_sd)
    got_g = {n: {k: p.grad for k, p in m.named_parameters()} for n, m in _nets(state).items()}
    check_grads(got_g, want_g)
    # no loss reaches the seg decoder: zero gradients, as jax.grad gives
    assert not got_g["d1"]["dec1.weight"].any() and not got_g["d2"]["seg_out.bias"].any()
    for net in NETS:  # lr 0 moves no parameter
        for k, p in _nets(state)[net].named_parameters():
            torch.testing.assert_close(p, before[net][k], rtol=0, atol=0)


def test_seg_discriminator_computes_in_float32():
    """As the JAX module (no dtype: its float32 parameters promote a bf16
    input), whatever compute_dtype; the bf16 seg step then runs."""
    x = np.zeros((2, 64, 64, 1), np.float32)
    jd = jl.SegDiscriminator(ndf=8, n_layers=3)
    v = jax.eval_shape(functools.partial(jd.init, train=True), jax.random.PRNGKey(0),
                       jnp.asarray(x))
    jout = jax.eval_shape(functools.partial(jd.apply, train=True, mutable=["batch_stats"]),
                          v, jnp.asarray(x, jnp.bfloat16))[0]
    assert all(o.dtype == jnp.float32 for o in jout)
    cfg = pix2pix.Pix2PixConfig(**SMALL, compute_dtype="bfloat16")
    state = pix2pix.init_state(cfg, seed=0, device="cpu")
    xb = torch.zeros(2, 64, 64, 1, dtype=torch.bfloat16)
    assert all(o.dtype == torch.float32 for o in state.d1(xb))
    assert pix2pix._d_logits(state.d1, xb).dtype == torch.float32
    state, losses = pix2pix.train_step(
        state, {k: torch.from_numpy(v) for k, v in _batch().items()}, 2e-4, cfg)
    assert all(np.isfinite(float(v)) for v in losses.values()), losses
    assert all(p.dtype == torch.float32 for p in state.d1.parameters())


def test_seg_checkpoint_carries_the_discriminators_and_adam(tmp_path):
    """save_checkpoint / restore_checkpoint at net_d="seg": the seg
    discriminators' state dicts (running statistics included) and their
    Adam moments, the decoder's zero ones too."""
    cfg = pix2pix.Pix2PixConfig(**SMALL)
    state = pix2pix.init_state(cfg, seed=1, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    state, _ = pix2pix.train_step(state, batch, 2e-4, cfg)
    ckpt.save_checkpoint(state, tmp_path)
    fresh = ckpt.restore_checkpoint(pix2pix.init_state(cfg, seed=2, device="cpu"), tmp_path)
    assert fresh.step == 1
    for name in ("d1", "d2", "d3"):
        for k, v in getattr(state, name).state_dict().items():
            torch.testing.assert_close(getattr(fresh, name).state_dict()[k], v, rtol=0, atol=0)
        opt, opt2 = getattr(state, f"opt_{name}"), getattr(fresh, f"opt_{name}")
        assert len(opt2.state) == len(list(getattr(state, name).parameters()))
        for p, p2 in zip(getattr(state, name).parameters(), getattr(fresh, name).parameters()):
            torch.testing.assert_close(opt2.state[p2]["exp_avg"], opt.state[p]["exp_avg"],
                                       rtol=0, atol=0)
    assert not fresh.opt_d1.state[fresh.d1.dec2.weight]["exp_avg_sq"].any()


def test_netD_seg_reaches_the_config():
    opt = types.SimpleNamespace(ndf=8, netD="seg", n_layers_D=3, lr=2e-4, beta1=0.5,
                                gan_mode="vanilla", crop_size=64)
    cfg = config_from_opt(opt)
    assert cfg.net_d == "seg"
    d = pix2pix.build_discriminator(cfg)
    assert isinstance(d, legacy.SegDiscriminator) and d.n_layers == 3
    assert all(isinstance(m, BatchNorm) for n, m in d.named_modules() if n.endswith("_bn"))


def test_seg_remat_step_equals_the_plain_step():
    """remat recomputes the generator forward in the backward: at net_d="seg"
    the step's losses and gradients are bit-equal to the plain step's."""
    batch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    runs = []
    for remat in (False, True):
        cfg = pix2pix.Pix2PixConfig(**SMALL, remat=remat)
        state = pix2pix.init_state(cfg, seed=3, device="cpu")
        state, losses = pix2pix.train_step(state, batch, 2e-4, cfg)
        runs.append(({k: float(v) for k, v in losses.items()},
                     {k: p.grad.clone() for k, p in state.d2.named_parameters()}))
    assert runs[0][0] == runs[1][0]
    for k, g in runs[0][1].items():
        torch.testing.assert_close(runs[1][1][k], g, rtol=0, atol=0)


def test_train_cli_trains_resumes_and_evaluates_with_netD_seg(tmp_path, capsys):
    from cli_cohort import write_cohort
    from healthivert_tpu_torch.cli import train as train_cli

    cohort = write_cohort(str(tmp_path / "cohort"))
    flags = ["--gpu_ids", "-1", "--dataroot", cohort, "--checkpoints_dir", str(tmp_path / "ck"),
             "--crop_size", "64", "--batch_size", "2", "--ndf", "8", "--netD", "seg",
             "--eval_freq", "1", "--print_freq", "2", "--n_epochs", "1", "--n_epochs_decay", "0",
             "--num_threads", "1", "--mesh", "data:1", "--name", "seg"]
    state, cfg = train_cli.main(flags + ["--max_steps", "2"])
    assert cfg.net_d == "seg" and isinstance(state.d3, legacy.SegDiscriminator)
    run_dir = tmp_path / "ck" / "seg"
    assert '"tag": "eval"' in (run_dir / "metrics.jsonl").read_text()
    saved = torch.load(run_dir / "latest.pt", weights_only=True)
    assert saved["step"] == 2 and "dec1_bn.running_var" in saved["d1"]
    capsys.readouterr()
    resumed, _ = train_cli.main(flags + ["--max_steps", "3", "--continue_train"])
    assert "at step 2" in capsys.readouterr().out and resumed.step == 3
