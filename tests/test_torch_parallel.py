"""Port vs JAX package on the CPU: the device mesh, global BatchNorm
statistics, and the sharded 3D synthesis and evaluation.

- make_mesh's axis sizes equal the JAX package's for the specs of
  tests/test_parallel.py; pad_batch and process_batch_slice are bit-equal to
  its for every rank of 2 and 4 processes;
- global BatchNorm: two gloo ranks (tests/torch_dist_worker.py), each with
  half of a batch of 4, against the JAX NLayerDiscriminator (ndf 8) on a
  `data:2` mesh: outputs, running statistics and input gradients at rtol
  2e-5 / atol 2e-5, the tolerance of the JAX package's own 1-vs-2-device
  test (test_batchnorm_global_stats_across_shards);
- synthesize_volumes over a mesh of two CPU shards bit-equal to the
  unsharded call with each shard's batch size, and within the tolerance of
  tests/test_torch_infer3d.py (|delta CT| <= 1 grey level, labels equal on
  >= 99.9 % of voxels) of the JAX package's on its `data:2` mesh; once at
  the production slice shape, the shipped generator at 256 x 256;
- evaluate_model over a mesh of two CPU shards, with a batch of 3 that the
  mesh does not divide: the averages of the unsharded call.
"""

import jax
import numpy as np
import pytest
import torch

from healthivert_tpu.engine.infer3d import synthesize_volumes as jax_synthesize_volumes
from healthivert_tpu.models.discriminator import NLayerDiscriminator as JaxD
from healthivert_tpu.models.pix2pix import Pix2PixConfig as JaxConfig
from healthivert_tpu.parallel import distributed as jdist
from healthivert_tpu.parallel import mesh as jmesh
from healthivert_tpu_torch.data.synthetic import SyntheticDataset, make_spine_volume
from healthivert_tpu_torch.engine import infer3d
from healthivert_tpu_torch.engine.checkpoint import PRETRAINED_NPZ, load_generator
from healthivert_tpu_torch.engine.evaluate import evaluate_model
from healthivert_tpu_torch.models.generator import Generator
from healthivert_tpu_torch.models.pix2pix import Pix2PixConfig
from healthivert_tpu_torch.parallel import distributed, mesh
from healthivert_tpu_torch.utils.weights import flax_discriminator_to_state_dict, flax_to_state_dict
from torch_dist_worker import Ranks
from torch_port_fixtures import random_generator_vars
from torch_port_fixtures import one_torch_thread  # noqa: F401 (fixture)

CPU2 = ["cpu", "cpu"]


def test_make_mesh_shapes_match_jax():
    for spec in ("data:8", "data:4,model:2", "data:-1", "data:-1,model:2", "data:2"):
        want = dict(jmesh.make_mesh(spec).shape)
        assert mesh.mesh_shape(spec, len(jax.devices())) == want, spec
        m = mesh.make_mesh(spec, devices=["cpu"] * 8)
        assert m.shape == want and m.processes == 1 and m.size == want["data"]
        assert len(m.devices) == want["data"] * want.get("model", 1)
        assert len(m.data_devices) == m.size
    with pytest.raises(ValueError, match="torchrun --nproc_per_node 2"):
        mesh.make_mesh("data:2", devices=["cpu"])


@pytest.mark.parametrize("spec", ["data:2,model:2", "model:2,data:2", "data:-1,model:2"])
def test_model_axis_layout_matches_jax(monkeypatch, spec):
    """The devices lie in the spec's axis order, as the JAX package's
    reshape lays them out; each data shard runs on the first device of its
    model group; under a 2 x 2 process group each rank takes the batch
    slice of its data coordinate, and the model axis's replicas() is 2."""
    jm = jmesh.make_mesh(spec, devices=jax.devices()[:4])
    ids = np.vectorize(lambda d: d.id)(jm.devices)
    axes = list(jm.axis_names)
    m = mesh.make_mesh(spec, devices=[f"cuda:{i}" for i in range(4)])
    assert [d.index for d in m.devices] == ids.reshape(-1).tolist()
    first = np.moveaxis(ids, axes.index("data"), 0).reshape(2, -1)[:, 0]
    assert [d.index for d in m.data_devices] == first.tolist()

    monkeypatch.setattr(distributed, "_DATA_AXIS", None)
    monkeypatch.setattr(distributed, "process_count", lambda: 4)
    for rank in range(4):
        monkeypatch.setattr(distributed, "process_index", lambda: rank)
        m = mesh.make_mesh(spec, devices=["cpu"])
        assert m.processes == 4 and m.data_devices == (torch.device("cpu"),)
        coord = int(np.argwhere(ids == rank)[0][axes.index("data")])
        assert distributed.data_axis() == (coord, 2)
        assert distributed.process_batch_slice(8) == slice(4 * coord, 4 * coord + 4)
        assert distributed.replicas() == 2
    with pytest.raises(ValueError, match="--nproc_per_node 8"):
        mesh.make_mesh("data:4,model:2", devices=["cpu"])


def test_make_mesh_needs_a_card_or_devices(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="devices="):
        mesh.make_mesh("data:-1")


def test_pad_batch_and_process_batch_slice_match_jax(monkeypatch, rng):
    batch = {"x": rng.random((3, 4, 4)).astype(np.float32),
             "h": np.arange(3, dtype=np.int64)}
    for size in (3, 4, 8, 9):
        got, want = mesh.pad_batch(batch, size), jmesh.pad_batch(batch, size)
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
            assert got[k].dtype == want[k].dtype
    for world in (2, 4):
        for rank in range(world):
            monkeypatch.setattr(distributed, "process_count", lambda: world)
            monkeypatch.setattr(distributed, "process_index", lambda: rank)
            monkeypatch.setattr(jax, "process_count", lambda: world)
            monkeypatch.setattr(jax, "process_index", lambda: rank)
            for gb in (4, 8, 32):
                assert distributed.process_batch_slice(gb) == jdist.process_batch_slice(gb)


def test_helpers_are_the_identity_without_a_process_group():
    assert distributed.process_count() == 1 and distributed.process_index() == 0
    assert distributed.process_batch_slice(16) == slice(0, 16)
    assert distributed.ensure_initialized(device="cpu") == 1  # no torchrun environment
    t = torch.arange(3.0, requires_grad=True)
    assert distributed.all_reduce_sum(t) is t and distributed.all_reduce_mean(t) is t


def test_shard_batch_and_replicate_state(rng):
    m = mesh.make_mesh("data:2", devices=CPU2)
    batch = {"x": rng.random((4, 3)).astype(np.float32)}
    shards = mesh.shard_batch(batch, m)
    assert len(shards) == 2
    np.testing.assert_array_equal(torch.cat([s["x"] for s in shards]).numpy(), batch["x"])
    gen = torch.nn.Linear(2, 2)
    assert mesh.replicate_state(gen, m) == [gen, gen]  # one device: one replica
    with pytest.raises(ValueError, match="equal shards"):
        mesh.split_batch({"x": np.zeros(3)}, 2)


def test_global_batchnorm_matches_jax_on_a_data2_mesh(tmp_path, rng):
    from jax.sharding import NamedSharding, PartitionSpec as P

    d = JaxD(ndf=8, n_layers=3, norm="batch")
    x = rng.standard_normal((4, 64, 64, 1)).astype(np.float32)
    variables = d.init(jax.random.PRNGKey(0), jax.numpy.asarray(x), train=True)
    sd = flax_discriminator_to_state_dict(jax.device_get(variables["params"]),
                                          jax.device_get(variables["batch_stats"]))
    w = rng.standard_normal((4, 6, 6, 1)).astype(np.float32)
    ranks = Ranks(tmp_path, [("bn", "bn", dict(ndf=8, sd=sd, x=x, w=w))])

    def fwd(v, x):
        out, upd = d.apply(v, x, train=True, mutable=["batch_stats"])
        return jax.numpy.sum(out * w), (out, upd["batch_stats"])

    m = jmesh.make_mesh("data:2")
    xs = jax.device_put(x, NamedSharding(m, P("data")))
    (_, (out, stats)), gx = jax.jit(jax.value_and_grad(fwd, argnums=1, has_aux=True))(
        jmesh.replicate_state(variables, m), xs)
    want_stats = flax_discriminator_to_state_dict(jax.device_get(variables["params"]),
                                                  jax.device_get(stats))
    res = [r["bn"] for r in ranks.results()]
    tol = dict(rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(torch.cat([r["out"] for r in res]).numpy(), np.asarray(out), **tol)
    np.testing.assert_allclose(torch.cat([r["grad"] for r in res]).numpy(), np.asarray(gx), **tol)
    assert len(res[0]["stats"]) == 6
    for k, v in res[0]["stats"].items():
        np.testing.assert_allclose(v.numpy(), want_stats[k].numpy(), **tol, err_msg=k)
        assert torch.equal(v, res[1]["stats"][k]), k  # every rank updates the same way


def _spine(shape=(64, 64, 16), vert_height=12, gap=5):
    return make_spine_volume(np.random.default_rng(0), shape=shape, vert_ids=(19, 20, 21),
                             vert_height=vert_height, gap=gap, fractured={20: 0.6})


def _synth(gen, cfg, vols, batch_size, m=None):
    before = infer3d._forward.dispatches
    out = infer3d.synthesize_volumes(gen, cfg, vols, batch_size=batch_size, use_bf16=False,
                                     mesh=m, device="cpu")
    return out, infer3d._forward.dispatches - before


def test_sharded_synthesis_matches_unsharded_and_jax():
    v = random_generator_vars(4)
    gen = Generator(cnum=4)
    gen.load_state_dict(flax_to_state_dict(v["params"], v["sn"]))
    gen.eval()
    cfg = Pix2PixConfig(ngf=4, image_size=64)
    ct, labels, cam = _spine()
    vols = [(ct, labels, 20, cam), (ct, labels, 21, cam)]
    plain, n_plain = _synth(gen, cfg, vols, 4)
    # batch 7 rounds up to 8: two shards of the unsharded call's 4
    sharded, n_sharded = _synth(gen, cfg, vols, 7, mesh.make_mesh("data:2", devices=CPU2))
    # per pass ceil(jobs / 8) dispatches of two shards against ceil(jobs / 4)
    assert n_sharded % 2 == 0 and n_plain < n_sharded <= n_plain + 3
    for (a_ct, a_lb), (b_ct, b_lb) in zip(sharded, plain):
        np.testing.assert_array_equal(a_ct, b_ct)
        np.testing.assert_array_equal(a_lb, b_lb)
    want = jax_synthesize_volumes(v["params"], v["sn"], JaxConfig(ngf=4, image_size=64), vols,
                                  batch_size=7, use_bf16=False, mesh=jmesh.make_mesh("data:2"))
    for (g_ct, g_lb), (w_ct, w_lb) in zip(sharded, want):
        assert np.abs(g_ct - w_ct).max() <= 1.0
        assert np.mean(g_lb == w_lb) >= 0.999
    m = mesh.Mesh({"data": 2}, (torch.device("cpu"),), processes=2)
    with pytest.raises(ValueError, match="one process"):
        infer3d.synthesize_volumes(gen, cfg, vols, mesh=m, use_bf16=False, device="cpu")


def test_model_axis_synthesis_matches_unsharded():
    """data:2,model:2 over the CPU four times: each data shard runs once
    (the model replicas would compute the same numbers), so it dispatches
    as data:2 does and is bit-equal to the unsharded call."""
    v = random_generator_vars(4)
    gen = Generator(cnum=4)
    gen.load_state_dict(flax_to_state_dict(v["params"], v["sn"]))
    gen.eval()
    cfg = Pix2PixConfig(ngf=4, image_size=64)
    ct, labels, cam = _spine()
    vols = [(ct, labels, 20, cam)]
    plain, _ = _synth(gen, cfg, vols, 4)
    data2, n_data2 = _synth(gen, cfg, vols, 8, mesh.make_mesh("data:2", devices=CPU2))
    m = mesh.make_mesh("data:2,model:2", devices=["cpu"] * 4)
    assert m.shape == {"data": 2, "model": 2} and len(m.data_devices) == 2
    got, n_got = _synth(gen, cfg, vols, 8, m)
    assert n_got == n_data2
    for (a_ct, a_lb), (b_ct, b_lb) in zip(got, plain):
        np.testing.assert_array_equal(a_ct, b_ct)
        np.testing.assert_array_equal(a_lb, b_lb)


@pytest.mark.usefixtures("one_torch_thread")
def test_sharded_synthesis_of_the_shipped_generator_at_256():
    cfg = Pix2PixConfig(ngf=16, image_size=256)
    gen = load_generator(PRETRAINED_NPZ, cfg, device="cpu")
    ct, labels, cam = _spine(shape=(256, 256, 8), vert_height=26, gap=10)
    vols = [(ct, labels, 20, cam)]
    plain, n_plain = _synth(gen, cfg, vols, 4)
    sharded, n_sharded = _synth(gen, cfg, vols, 8, mesh.make_mesh("data:2", devices=CPU2))
    assert n_sharded % 2 == 0 and n_plain <= n_sharded <= n_plain + 3
    (a_ct, a_lb), (b_ct, b_lb) = sharded[0], plain[0]
    np.testing.assert_array_equal(a_ct, b_ct)
    np.testing.assert_array_equal(a_lb, b_lb)
    assert (a_lb == 20).any()


def test_sharded_evaluation_matches_unsharded(tmp_path):
    v = random_generator_vars(4)
    gen = Generator(cnum=4)
    gen.load_state_dict(flax_to_state_dict(v["params"], v["sn"]))
    cfg = Pix2PixConfig(ngf=4, image_size=64)
    ds = SyntheticDataset(batch_size=3, seed=1, shape=(64, 64, 16), vert_ids=(19, 20),
                          vert_height=14, gap=8, size=6)
    batches = list(ds)
    assert len(batches) == 2 and batches[0]["full"].shape[0] == 3
    want = evaluate_model(gen, batches, cfg, out_dir=str(tmp_path / "plain"))
    got = evaluate_model(gen, batches, cfg, out_dir=str(tmp_path / "sharded"),
                         mesh=mesh.make_mesh("data:2", devices=CPU2))
    assert got.keys() == want.keys() == {"ssim", "psnr", "dice", "iou", "diff_h"}
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-6, abs=1e-7), k
    assert (tmp_path / "sharded" / "nepoch_000_eval.png").exists()
    m = mesh.Mesh({"data": 2}, (torch.device("cpu"),), processes=2)
    with pytest.raises(ValueError, match="single-process only"):
        evaluate_model(gen, batches, cfg, mesh=m)
