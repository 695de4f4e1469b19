"""Port vs JAX package on the CPU: data-parallel training over two processes.

Two gloo ranks (tests/torch_dist_worker.py, a file store, one torch thread
each) start at the module's first test and run, while this process computes
the JAX references:

- train_step on its half of a global batch of 4 (ngf 8, ndf 8, 64 x 64,
  float32, lr 2e-4), for gan_head_preupdate True and False, from a state
  drawn in flax's shapes and carried over by utils/weights.py, against the
  JAX train_step on the same global batch sharded over a `data:2` mesh:
  the 13 losses at rtol 2e-4 / atol 2e-4 (the JAX package's 1-vs-8-device
  tolerance, tests/test_parallel.py), and u, the running statistics, every
  gradient and every update at the tolerances of
  tests/test_torch_train_step.py (torch_port_fixtures.check_*); the two
  ranks' networks bit-equal to each other;
- the same step with the two ranks on a `data:1,model:2` mesh (the JAX
  package's replicated model axis: each rank the whole batch of 4) against
  the same JAX step, at the same tolerances;
- AlignedDataset (training split, global batch 4) on tests/cli_cohort.py:
  each rank's batches bit-equal to its rows of the one-process global
  batches, the trailing one padded to the global size first;
- the train CLI on that cohort (--gpu_ids -1, global batch 4, 2 steps,
  evaluation each epoch, web visuals at step 1) against one process on the
  same global batches: the updated generator's sum of |w| within rtol 1e-5,
  as the JAX package's test_two_process_training_launch holds it; the ranks
  bit-equal; one latest.pt and one loss log, written by rank 0 alone.
"""

import functools
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cli_cohort import write_cohort
from healthivert_tpu.data.synthetic import SyntheticDataset
from healthivert_tpu.models import pix2pix as jpix
from healthivert_tpu.parallel import mesh as jmesh
from healthivert_tpu_torch.cli import train as train_cli
from healthivert_tpu_torch.data.aligned import AlignedDataset
from healthivert_tpu_torch.parallel.mesh import pad_batch
from torch_dist_worker import Ranks
from torch_port_fixtures import (
    NETS,
    check_deltas,
    check_grads,
    check_sn_and_stats,
    draw_jax_train_state,
    jax_adam_grads,
    jax_state_dicts,
)
from torch_port_fixtures import one_torch_thread  # noqa: F401 (fixture)

SMALL = dict(ngf=8, ndf=8, image_size=64)
LR = 2e-4
PREUPDATE = [True, False]
CLI = ["--gpu_ids", "-1", "--crop_size", "64", "--batch_size", "4", "--ndf", "8",
       "--max_steps", "2", "--print_freq", "4", "--eval_freq", "1", "--display_freq", "4",
       "--n_epochs", "2", "--n_epochs_decay", "0", "--num_threads", "1", "--name", "run"]
ALIGNED = dict(batch_size=4, seed=0, phase="train", num_threads=1, isTrain=True,
               serial_batches=False, data_cache_gb=0.0)


@functools.lru_cache(maxsize=None)
def _batch():
    ds = SyntheticDataset(batch_size=4, seed=0, shape=(64, 64, 16), vert_ids=(19, 20),
                          vert_height=14, gap=8)
    return {k: np.asarray(v) for k, v in ds.sample_batch().items()}


def _jcfg(preupdate):
    return jpix.Pix2PixConfig(**SMALL, gan_head_preupdate=preupdate)


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    return write_cohort(str(tmp_path_factory.mktemp("cohort")))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, cohort):
    """The two ranks' results, started once for the module."""
    out = tmp_path_factory.mktemp("ranks")
    sds = jax_state_dicts(draw_jax_train_state(_jcfg(True)))
    tasks = [(f"step_{p}", "step", dict(cfg=dict(SMALL, gan_head_preupdate=p), sds=sds,
                                        batch=_batch(), lr=LR)) for p in PREUPDATE]
    tasks += [("aligned", "aligned", dict(ALIGNED, dataroot=cohort)),
              ("train", "train_cli", dict(argv=CLI + ["--dataroot", cohort, "--checkpoints_dir",
                                                      str(out / "ck")])),
              # last: its mesh sets the ranks' data coordinate
              ("step_model", "step", dict(cfg=dict(SMALL, gan_head_preupdate=True), sds=sds,
                                          batch=_batch(), lr=LR, mesh="data:1,model:2"))]
    return types.SimpleNamespace(before=sds, results=functools.cache(Ranks(out, tasks).results),
                                 run_dir=out / "ck" / "run")


@functools.lru_cache(maxsize=None)
def _jax_step(preupdate):
    m = jmesh.make_mesh("data:2")
    state = jmesh.replicate_state(jax.device_get(draw_jax_train_state(_jcfg(preupdate))), m)
    new, losses = jpix.train_step(state, jmesh.shard_batch(_batch(), m), jnp.float32(LR),
                                  _jcfg(preupdate))
    return {k: float(v) for k, v in losses.items()}, jax_state_dicts(new), jax_adam_grads(new)


@pytest.mark.parametrize("preupdate", PREUPDATE, ids=["preupdate", "postupdate"])
def test_two_rank_train_step_matches_jax_on_a_data2_mesh(ranks, preupdate):
    want_l, want_sd, want_g = _jax_step(preupdate)
    r0, r1 = (r[f"step_{preupdate}"] for r in ranks.results())
    assert r0["losses"] == r1["losses"]
    assert set(r0["losses"]) == set(want_l) and len(want_l) == 13
    for k, w in want_l.items():
        assert r0["losses"][k] == pytest.approx(w, rel=2e-4, abs=2e-4), k
    for net in NETS:
        for k, v in r0["after"][net].items():
            assert torch.equal(v, r1["after"][net][k]), (net, k)
    check_sn_and_stats(r0["after"], want_sd)
    check_grads(r0["grads"], want_g)
    check_deltas(ranks.before, r0["after"], want_sd, r0["grads"], want_g, LR)


def test_two_rank_model_axis_step_matches_jax(ranks):
    """data:1,model:2: both ranks hold the whole batch and the same
    weights; the gradient mean, BatchNorm's global sums and the mask count
    over the two replicas give the one-shard step."""
    want_l, want_sd, want_g = _jax_step(True)
    r0, r1 = (r["step_model"] for r in ranks.results())
    assert r0["losses"] == r1["losses"]
    for k, w in want_l.items():
        assert r0["losses"][k] == pytest.approx(w, rel=2e-4, abs=2e-4), k
    for net in NETS:
        for k, v in r0["after"][net].items():
            assert torch.equal(v, r1["after"][net][k]), (net, k)
    check_sn_and_stats(r0["after"], want_sd)
    check_grads(r0["grads"], want_g)
    check_deltas(ranks.before, r0["after"], want_sd, r0["grads"], want_g, LR)


def test_aligned_dataset_loads_each_rank_its_slice(ranks, cohort):
    one = list(AlignedDataset(types.SimpleNamespace(**dict(ALIGNED, isTrain=False),
                                                    dataroot=cohort)))
    per_rank = [r["aligned"] for r in ranks.results()]
    assert [r["world"] for r in ranks.results()] == [2, 2]
    assert len(one) == 2 and one[-1]["full"].shape[0] == 1  # 5 vertebrae, batch 4
    for rank, batches in enumerate(per_rank):
        assert len(batches) == len(one)
        for got, want in zip(batches, one):
            want = pad_batch(want, 4)
            assert got.keys() == want.keys()
            for k in want:
                np.testing.assert_array_equal(got[k], want[k][2 * rank:2 * rank + 2], err_msg=k)


def _abs_sum(sd):
    return float(sum(v.double().abs().sum() for v in sd.values()))


@pytest.mark.usefixtures("one_torch_thread")
def test_two_process_training_matches_one_process(ranks, cohort, tmp_path):
    state, _ = train_cli.main(CLI + ["--dataroot", cohort, "--checkpoints_dir",
                                     str(tmp_path / "ck")])
    r0, r1 = (r["train"] for r in ranks.results())
    assert r0["step"] == r1["step"] == state.step == 2
    for k, v in r0["gen"].items():
        assert torch.equal(v, r1["gen"][k]), k
    want = {k: v.detach() for k, v in state.gen.state_dict().items()}
    assert _abs_sum(r0["gen"]) == pytest.approx(_abs_sum(want), rel=1e-5)
    run_dir = ranks.run_dir
    files = sorted(os.listdir(run_dir))
    assert "latest.pt" in files and "loss_log.txt" in files
    assert not [f for f in files if f.endswith(".tmp")]
    log = (run_dir / "loss_log.txt").read_text()
    assert log.count("Training Loss") == 1  # one Visualizer: rank 0's
    assert os.path.isfile(run_dir / "web" / "index.html")
