"""The traffic is a function of the seed: the spines of the 3D synthesis,
and the training batches the reference works out again, which equal the
system's own."""

import numpy as np
import pytest
import torch

from hv_bench import spines
from hv_bench.reference import data as ref_data

TRAFFIC = dict(shape=[64, 64, 16], vert_ids=[19, 20, 21], vert_height=10, gap=4,
               fracture=[0.5, 0.9])


def _same(a, b):
    return all(np.array_equal(x[i], y[i]) for x, y in zip(a, b) for i in (0, 1, 3))


def test_spines_repeat_by_seed():
    a = spines.patients(2 ** 31 + 7, 2, TRAFFIC, "cpu")
    b = spines.patients(2 ** 31 + 7, 2, TRAFFIC, "cpu")
    assert all(_same(p, q) for p, q in zip(a, b))


def test_spines_differ_by_seed_and_patient():
    a = spines.patients(5, 2, TRAFFIC, "cpu")
    b = spines.patients(6, 2, TRAFFIC, "cpu")
    assert not np.array_equal(a[0][0][0], b[0][0][0])
    assert not np.array_equal(a[0][0][0], a[1][0][0])


def test_spine_shapes_and_fracture():
    (vols,) = spines.patients(11, 1, TRAFFIC, "cpu")
    assert [v[2] for v in vols] == [19, 20, 21]
    ct, labels, _, cam = vols[0]
    assert ct.shape == labels.shape == cam.shape == (64, 64, 16)
    assert 0 <= ct.min() and ct.max() <= 255
    assert set(np.unique(labels)) == {0, 19, 20, 21}
    fractured = [v for v in (19, 20, 21) if cam[labels == v].max() > 0]
    assert len(fractured) == 1


def test_seed_stream_is_a_large_int():
    s = spines.seed_stream(2 ** 33 + 1, 2)
    assert 0 <= s < 2 ** 63 and s != spines.seed_stream(2 ** 33 + 1, 1)


@pytest.mark.parametrize("seed", [3, 2 ** 32 + 5])
def test_reference_batches_equal_the_systems(seed):
    from types import SimpleNamespace

    from healthivert_tpu_torch.data.synthetic import SyntheticDataset

    opt = SimpleNamespace(batch_size=4, seed=seed, crop_size=64, synthetic_cache=16)
    ds = SyntheticDataset(opt)
    got = [ds.sample_batch() for _ in range(3)]
    want = ref_data.batches(seed, 3, 4, 16, crop_size=64)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            assert g[k].dtype == w[k].dtype and np.array_equal(g[k], w[k]), k


def test_reference_batch_of_a_later_step_equals_the_systems():
    from types import SimpleNamespace

    from healthivert_tpu_torch.data.synthetic import SyntheticDataset

    opt = SimpleNamespace(batch_size=4, seed=2 ** 31 + 3, crop_size=64, synthetic_cache=16)
    ds = SyntheticDataset(opt)
    got = [ds.sample_batch() for _ in range(23)][-1]
    (want,) = ref_data.batches(opt.seed, 1, 4, 16, crop_size=64, first=23)
    for k in got:
        assert np.array_equal(got[k], want[k]), k


def test_weights_repeat_by_seed():
    from hv_bench import weights
    from hv_bench.reference import model as ref

    t = ref.Nets(16, 8, 3).state_dict()
    a, b = weights.make(t, 9, "cpu"), weights.make(t, 9, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in t)
    assert torch.all(a["d1.norm1.running_var"] == 1)
    assert abs(float(torch.linalg.vector_norm(a["gen.coarse_generator.conv1.conv.u"])) - 1) < 1e-5
