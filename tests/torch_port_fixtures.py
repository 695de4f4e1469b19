"""Shared helper of the port's parity tests (tests/test_torch_*.py)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from healthivert_tpu.models.generator import Generator as JaxGenerator


def random_generator_vars(cnum, seed=0):
    """{"params", "sn"} trees of the flax generator, drawn with numpy from a
    seed in the shapes flax would initialise: kernels N(0, 1/fan_in) (flax's
    lecun normal), small non-zero biases, unit-norm spectral-norm vectors."""
    x = jnp.zeros((1, 64, 64, 1))
    shapes = jax.eval_shape(
        JaxGenerator(cnum=cnum).init, jax.random.PRNGKey(0), x, x, x, jnp.zeros((1,))
    )
    rng = np.random.default_rng(seed)

    def draw(path, s):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(s.shape[:-1]))
            return (rng.standard_normal(s.shape) / np.sqrt(fan_in)).astype(np.float32)
        if name == "bias":
            return (0.01 * rng.standard_normal(s.shape)).astype(np.float32)
        u = rng.standard_normal(s.shape)
        return (u / np.linalg.norm(u)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def random_train_trees(ngf=4, ndf=8, image_size=64, seed=0):
    """Numpy trees of a JAX TrainState's networks, drawn from a seed in the
    shapes flax would initialise: {"g_params", "g_sn", "d{i}_params",
    "d{i}_stats"} (generator kernels N(0, 1/fan_in), discriminator kernels
    N(0, 0.02), BatchNorm scales N(1, 0.02), running statistics away from
    their init, small biases, unit u vectors)."""
    from healthivert_tpu.models import pix2pix as jpix

    cfg = jpix.Pix2PixConfig(ngf=ngf, ndf=ndf, image_size=image_size)
    shapes = jax.eval_shape(lambda: jpix.init_state(jax.random.PRNGKey(0), cfg))
    rng = np.random.default_rng(seed)

    def draw(field, path, s):
        leaf = getattr(path[-1], "key", None)
        if field == "g_sn":
            u = rng.standard_normal(s.shape)
            return (u / np.linalg.norm(u)).astype(np.float32)
        if leaf == "kernel":
            std = 1 / np.sqrt(np.prod(s.shape[:-1])) if field == "g_params" else 0.02
            return (std * rng.standard_normal(s.shape)).astype(np.float32)
        if leaf == "scale":
            return (1 + 0.02 * rng.standard_normal(s.shape)).astype(np.float32)
        if leaf == "mean":
            return (0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        if leaf == "var":
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        return (0.01 * rng.standard_normal(s.shape)).astype(np.float32)

    fields = ["g_params", "g_sn"] + [f"d{i}_{k}" for i in (1, 2, 3) for k in ("params", "stats")]
    return {f: jax.tree_util.tree_map_with_path(functools.partial(draw, f), getattr(shapes, f))
            for f in fields}


def draw_jax_train_state(jcfg, seed=0):
    """A JAX TrainState with variables drawn by numpy in flax's shapes:
    generator kernels N(0, 1/fan_in), discriminator kernels N(0, 0.02),
    BatchNorm scales N(1, 0.02), small non-zero biases, unit u vectors,
    running statistics away from their init; zero Adam states."""
    from healthivert_tpu.models import pix2pix as jpix

    shapes = jax.eval_shape(lambda: jpix.init_state(jax.random.PRNGKey(0), jcfg, 2))
    rng = np.random.default_rng(seed)

    def draw(path, s):
        field = path[0].name
        leaf = getattr(path[-1], "key", None)
        if not field.endswith(("params", "sn", "stats")):
            return np.zeros(s.shape, s.dtype)  # step, Adam count/mu/nu
        if field == "g_sn":
            u = rng.standard_normal(s.shape)
            return (u / np.linalg.norm(u)).astype(np.float32)
        if leaf == "kernel":
            std = 1 / np.sqrt(np.prod(s.shape[:-1])) if field == "g_params" else 0.02
            return (std * rng.standard_normal(s.shape)).astype(np.float32)
        if leaf == "scale":
            return (1 + 0.02 * rng.standard_normal(s.shape)).astype(np.float32)
        if leaf == "mean":
            return (0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        if leaf == "var":
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        return (0.01 * rng.standard_normal(s.shape)).astype(np.float32)  # biases

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _d_bridge(legacy):
    from healthivert_tpu_torch.utils import weights

    return (weights.flax_legacy_to_state_dict if legacy
            else weights.flax_discriminator_to_state_dict)


def jax_state_dicts(js, legacy=False):
    """Port state dicts of the four networks of a JAX TrainState (legacy:
    the discriminators are --netD seg's, models/legacy.py)."""
    from healthivert_tpu_torch.utils.weights import flax_to_state_dict

    d_sd = _d_bridge(legacy)
    return {
        "g": flax_to_state_dict(_np(js.g_params), _np(js.g_sn)),
        "d1": d_sd(_np(js.d1_params), _np(js.d1_stats)),
        "d2": d_sd(_np(js.d2_params), _np(js.d2_stats)),
        "d3": d_sd(_np(js.d3_params), _np(js.d3_stats)),
    }


def jax_adam_grads(js, legacy=False):
    """The JAX step's gradients, from Adam's first moment after one step."""
    from healthivert_tpu_torch.utils.weights import flax_to_state_dict

    d_sd = _d_bridge(legacy)
    g = lambda opt: jax.tree_util.tree_map(lambda m: np.asarray(m) / 0.5, opt.mu)
    return {
        "g": flax_to_state_dict(g(js.opt_g), {}),
        "d1": d_sd(g(js.opt_d1)),
        "d2": d_sd(g(js.opt_d2)),
        "d3": d_sd(g(js.opt_d3)),
    }

NETS = ("g", "d1", "d2", "d3")


def check_sn_and_stats(got_sd, want_sd):
    """A step's new spectral-norm vectors u (atol 1e-5 on unit vectors) and
    the discriminators' running statistics (atol 1e-5 on the mean, rtol
    1e-4 on the variance) against the JAX step's."""
    us = [k for k in want_sd["g"] if k.endswith(".u")]
    assert us
    for k in us:
        np.testing.assert_allclose(got_sd["g"][k].numpy(), want_sd["g"][k].numpy(),
                                   atol=1e-5, rtol=0, err_msg=k)
    for net in NETS[1:]:
        stats = [k for k in want_sd[net] if ".running_" in k]
        assert stats
        for k in stats:
            w, g = want_sd[net][k].numpy(), got_sd[net][k].numpy()
            if k.endswith("running_mean"):
                np.testing.assert_allclose(g, w, atol=1e-5, rtol=0, err_msg=f"{net} {k}")
            else:
                np.testing.assert_allclose(g, w, rtol=1e-4, atol=0, err_msg=f"{net} {k}")


def check_grads(got, want):
    """Every parameter gradient, per tensor: |got - want| <= 1e-3 * G +
    1e-3 * |want|, G the largest gradient of that network."""
    for net in NETS:
        assert set(got[net]) == set(want[net]), net
        scale = max(float(w.abs().max()) for w in want[net].values())
        assert scale > 0, net
        for k, w in want[net].items():
            err = (got[net][k] - w).abs()
            tol = 1e-3 * scale + 1e-3 * w.abs()
            assert bool((err <= tol).all()), (net, k, float(err.max()), scale)


def check_deltas(before, after, want_sd, got_g, want_g, lr):
    """One Adam step's parameter deltas against the JAX step's: within
    1e-3 * lr, except where the gradient sits at its rounding floor (|g| <=
    1e-5 * G in either package), where the update's sign may flip; those
    elements stay under 0.5 % of each network's parameters. Returns
    {net: (flipped elements, parameters)}."""
    report = {}
    for net in NETS:
        g_scale = max(float(w.abs().max()) for w in want_g[net].values())
        flips = total = 0
        for k in got_g[net]:
            d_want = want_sd[net][k] - before[net][k]
            d_got = after[net][k] - before[net][k]
            floor = (want_g[net][k].abs() <= 1e-5 * g_scale) | (got_g[net][k].abs() <= 1e-5 * g_scale)
            bad = (d_got - d_want).abs() > 1e-3 * lr
            assert not bool((bad & ~floor).any()), (net, k)
            flips += int((bad & floor).sum())
            total += d_got.numel()
            assert float(d_got.abs().max()) <= lr * (1 + 1e-3)
        report[net] = (flips, total)
        assert flips <= 0.005 * total, (net, flips, total)
    return report


def g_tree_to_reference_sd(params, sn):
    """flax generator trees -> the reference's torch key space (spectral-norm
    convs as weight_orig / weight_u / weight_v, Linear weights (out, in))."""
    import torch

    sd = {}

    def walk(node, path):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, path + [k])
            elif k == "kernel":
                a = np.asarray(v)
                if a.ndim == 4:
                    sd[".".join(path) + ".weight_orig"] = torch.from_numpy(
                        np.transpose(a, (3, 2, 0, 1)).copy())
                else:
                    sd[".".join(path) + ".weight"] = torch.from_numpy(a.T.copy())
            elif k == "bias":
                sd[".".join(path) + ".bias"] = torch.from_numpy(np.asarray(v).copy())

    def walk_sn(node, path):
        for k, v in node.items():
            if isinstance(v, dict):
                walk_sn(v, path + [k])
            elif k == "u":
                sd[".".join(path) + ".weight_u"] = torch.from_numpy(np.asarray(v).copy())
                sd[".".join(path) + ".weight_v"] = torch.zeros(1)

    walk(params, [])
    walk_sn(sn, [])
    return sd


def d_tree_to_reference_sd(params, stats, n_layers=3):
    """flax NLayerDiscriminator trees -> the reference's nn.Sequential
    ``model`` keys (conv0 at model.0, a (conv, norm, LeakyReLU) triple per
    layer from model.2, the output conv last), with num_batches_tracked."""
    import torch

    t = lambda a: torch.from_numpy(np.array(a, np.float32))
    sd = {}
    idx = {"conv0": 0, "conv_out": 2 + 3 * n_layers}
    idx.update({f"conv{n}": 2 + 3 * (n - 1) for n in range(1, n_layers + 1)})
    for name, node in params.items():
        if name.startswith("conv"):
            sd[f"model.{idx[name]}.weight"] = t(np.transpose(node["kernel"], (3, 2, 0, 1)))
            if "bias" in node:
                sd[f"model.{idx[name]}.bias"] = t(node["bias"])
        else:
            i = idx["conv" + name[4:]] + 1
            sd[f"model.{i}.weight"] = t(node["scale"])
            sd[f"model.{i}.bias"] = t(node["bias"])
            sd[f"model.{i}.running_mean"] = t(stats[name]["mean"])
            sd[f"model.{i}.running_var"] = t(stats[name]["var"])
            sd[f"model.{i}.num_batches_tracked"] = torch.tensor(7)
    return sd


@pytest.fixture(scope="module")
def one_torch_thread():
    """Run a module's tests with one torch CPU thread: their tensors are
    small, so one thread is as fast alone, and several test processes
    sharing the host's cores stop oversubscribing them."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

