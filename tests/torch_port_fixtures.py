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
