"""The port's HGAM classifier (healthivert_tpu_torch/models/hgam.py) against
the JAX package's (healthivert_tpu/models/hgam.py) on the same weights,
carried across with utils/weights.flax_classifier_to_state_dict, at width 8
on 64 x 64 slices of 5 channels: the features and logits within atol 1e-5,
Grad-CAM++ within atol 1e-5, three Adam steps to parameters within rtol
1e-4 (atol 1e-6 for the entries that start at zero) and losses within
1e-5; the init's per-tensor statistics against flax's distributions; the
classifier checkpoint.

One tensor is held apart in the train steps: at width 8 the first
GroupNorm has one channel a group, so it removes the first conv's bias and
that bias's gradient is zero but for rounding (~3e-8 here, in both
packages). Adam divides a gradient by its own magnitude, so each package
moves that bias by up to lr a step, in the direction of its own rounding.
The test holds the gradient below 1e-6 and each package's move within the
sum of the learning rates."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from healthivert_tpu.models import hgam as jhgam
from healthivert_tpu_torch.engine import checkpoint as ckpt
from healthivert_tpu_torch.models import hgam
from healthivert_tpu_torch.utils.weights import flatten_tree, flax_classifier_to_state_dict
from torch_port_fixtures import one_torch_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

WIDTH, SIZE, CH = 8, 64, 5


@pytest.fixture(scope="module")
def pair():
    jmodel = jhgam.FractureClassifier(width=WIDTH)
    params = jmodel.init(jax.random.PRNGKey(3), jnp.zeros((1, SIZE, SIZE, CH)))
    model = hgam.FractureClassifier(width=WIDTH, in_ch=CH)
    model.load_state_dict(flax_classifier_to_state_dict(jax.device_get(params)))
    return jmodel, params, model


def _batch(seed, n=4):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (n, SIZE, SIZE, CH)).astype(np.float32)
    x[: n // 2, 8:24, 8:24] += 1.0
    return x, (np.arange(n) < n // 2).astype(np.int64)


def test_features_and_logits(pair):
    jmodel, params, model = pair
    x, _ = _batch(0)
    jf = np.asarray(jmodel.apply(params, jnp.asarray(x), method="features"))
    jl = np.asarray(jmodel.apply(params, jnp.asarray(x)))
    with torch.no_grad():
        f = model.features(torch.from_numpy(x)).numpy()
        logits = model(torch.from_numpy(x)).numpy()
    assert f.shape == jf.shape == (4, SIZE // 16, SIZE // 16, 4 * WIDTH)
    np.testing.assert_allclose(f, jf, atol=1e-5, rtol=0)
    np.testing.assert_allclose(logits, jl, atol=1e-5, rtol=0)


@pytest.mark.parametrize("target_class", [0, 1])
def test_grad_cam_pp(pair, target_class):
    jmodel, params, model = pair
    x, _ = _batch(1)
    want = np.asarray(jhgam.grad_cam_pp(jmodel, params, jnp.asarray(x), target_class=target_class))
    got = hgam.grad_cam_pp(model, torch.from_numpy(x), target_class=target_class).numpy()
    assert got.shape == (4, SIZE, SIZE, 1) and got.min() >= 0 and got.max() <= 1 + 1e-6
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_three_train_steps(pair):
    jmodel, params, _ = pair
    model = hgam.FractureClassifier(width=WIDTH, in_ch=CH)
    model.load_state_dict(flax_classifier_to_state_dict(jax.device_get(params)))
    opt = hgam.make_optimizer(model)
    jparams = jax.tree_util.tree_map(jnp.array, params)
    opt_state = optax.scale_by_adam().init(jparams)
    lrs = (1e-3, 5e-4, 1e-3)
    for step, lr in enumerate(lrs):
        x, y = _batch(10 + step, n=6)
        jparams, opt_state, jloss, jacc = jhgam.classifier_train_step(
            jmodel, jparams, opt_state, jnp.asarray(x), jnp.asarray(y), jnp.float32(lr))
        loss, acc = hgam.classifier_train_step(model, opt, torch.from_numpy(x),
                                               torch.from_numpy(y), lr)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
        assert float(acc) == float(jacc)
        assert float(model.convs[0].bias.grad.abs().max()) < 1e-6
    start = flax_classifier_to_state_dict(jax.device_get(params))
    want = flax_classifier_to_state_dict(jax.device_get(jparams))
    got = model.state_dict()
    assert set(got) == set(want)
    for k in want:
        if k == "convs.0.bias":
            for moved in (got[k] - start[k], want[k] - start[k]):
                assert float(moved.abs().max()) <= sum(lrs) * (1 + 1e-5)
            continue
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=1e-4, atol=1e-6,
                                   err_msg=k)


def test_init_matches_flax_distributions():
    """Per-tensor mean and std of the port's init against flax's at width
    32 (a loose statistical bound: the draws differ, the distributions
    not)."""
    jparams = jhgam.FractureClassifier(width=32).init(jax.random.PRNGKey(0),
                                                      jnp.zeros((1, 32, 32, CH)))
    want = flax_classifier_to_state_dict(jax.device_get(jparams))
    model = hgam.init_classifier(hgam.FractureClassifier(width=32, in_ch=CH),
                                 torch.Generator().manual_seed(0))
    for k, t in model.state_dict().items():
        w, g = want[k].numpy(), t.numpy()
        assert g.shape == w.shape, k
        if k.endswith("weight") and g.ndim > 1:
            assert abs(g.std() / w.std() - 1) < 0.15, k
            assert abs(g.mean()) < 0.1 * w.std() + 3 * w.std() / np.sqrt(w.size), k
            assert np.abs(g).max() <= 2 * w.std() / 0.8796 * 1.2, k
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)


def test_classifier_checkpoint(pair, tmp_path):
    _, _, model = pair
    ckpt.save_classifier(model, tmp_path)
    other = hgam.init_classifier(hgam.FractureClassifier(width=WIDTH, in_ch=CH),
                                 torch.Generator().manual_seed(1))
    ckpt.restore_classifier(other, tmp_path)
    for k, v in model.state_dict().items():
        assert torch.equal(other.state_dict()[k], v)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["classifier.pt"]
    orbax_only = tmp_path / "jax_run"
    (orbax_only / "classifier").mkdir(parents=True)
    with pytest.raises(RuntimeError, match="flax_classifier_to_state_dict"):
        ckpt.restore_classifier(other, orbax_only)


def test_weight_bridge_rejects_unknown_variables(pair):
    _, params, _ = pair
    flat = flatten_tree(jax.device_get(params)["params"])
    assert len(flax_classifier_to_state_dict(params)) == len(flat) == 18
    with pytest.raises(ValueError, match="gn0/kernel"):
        flax_classifier_to_state_dict({"gn0": {"kernel": np.zeros((3, 3, 1, 8))}})
