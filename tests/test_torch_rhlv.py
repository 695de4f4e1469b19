"""The port's RHLV quantification (healthivert_tpu_torch/evaluation/rhlv.py)
and its table (utils/table.py) against the JAX package's
(healthivert_tpu/evaluation/rhlv.py, pandas):

- RHLV rows equal, value for value, to `process_datasets` of the JAX
  package on synthetic spines, sagittal (axis 2) and coronal (axis 1), and
  `calculate_rhlv` equal where the window would start below slice 0 (the
  clamp);
- a CSV the port writes reads back in pandas as a frame equal to the JAX
  writer's, byte for byte, and the JAX writer's CSV reads back in the port
  as the rows it holds; `merge_on` equals pandas' inner merge with
  suffixes.
"""

import os

import numpy as np
import pandas as pd
import pytest

from healthivert_tpu.evaluation import rhlv as jrhlv
from healthivert_tpu_torch.data.synthetic import make_spine_volume
from healthivert_tpu_torch.evaluation import rhlv
from healthivert_tpu_torch.utils import nifti, table


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    """Label and fake-label volumes (96 x 96 x 24) of 6 vertebrae: a
    compressed real vertebra 20 against a healthy fake, and healthy pairs;
    one vertebra without its id in the label volume (skipped)."""
    root = tmp_path_factory.mktemp("rhlv")
    (root / "label").mkdir()
    (root / "fake").mkdir()
    rng = np.random.default_rng(0)
    split = {"train": {}, "val": {}}
    for i, frac in enumerate((1.0, 0.5, 0.7, 1.0, 0.6, None)):
        _, healthy, _ = make_spine_volume(rng, shape=(96, 96, 24), vert_ids=(19, 20, 21),
                                          vert_height=14, gap=6)
        _, real, _ = make_spine_volume(rng, shape=(96, 96, 24), vert_ids=(19, 20, 21),
                                       vert_height=14, gap=6,
                                       fractured={20: frac} if frac else None)
        if frac is None:
            real = np.where(real == 20, 0, real)
        pv = f"c{i}_20"
        nifti.save(nifti.Nifti1Image(real.astype(np.int16)), str(root / "label" / f"{pv}.nii.gz"))
        nifti.save(nifti.Nifti1Image(healthy.astype(np.float32)),
                   str(root / "fake" / f"{pv}.nii.gz"))
        split["train" if i < 4 else "val"][pv] = 0 if frac in (1.0, None) else 3
    split["val"]["c9_20"] = 0  # no files: skipped
    return root, split


@pytest.mark.parametrize("axis", [2, 1])
def test_rows_equal_the_jax_package(cohort, tmp_path, axis):
    root, split = cohort
    args = (str(root / "label"), str(root / "fake"))
    want = jrhlv.process_datasets(split, *args, str(tmp_path / "jax.csv"), axis=axis)
    got = rhlv.process_datasets(split, *args, str(tmp_path / "port.csv"), axis=axis)
    assert len(got) == len(want) == 5
    assert got == want
    assert (tmp_path / "port.csv").read_bytes() == (tmp_path / "jax.csv").read_bytes()
    assert any(r["Pre RHLV"] > 0.1 for r in got)


def test_window_clamped_at_the_volume_edge():
    rng = np.random.default_rng(1)
    _, healthy, _ = make_spine_volume(rng, fractured={})
    _, real, _ = make_spine_volume(rng, fractured={20: 0.5})
    fake, lab = (healthy == 20).astype(np.float64), (real == 20).astype(np.float64)
    for center, length in ((2, 10), (10, 10), (0, 3)):
        got = rhlv.calculate_rhlv(fake, lab, center, length)
        assert got == jrhlv.calculate_rhlv(fake, lab, center, length)
    assert rhlv.calculate_rhlv(fake, lab, 2, 10)[:4] != (0.0, 0.0, 0.0, 0.0)


ROWS = [
    {"Vertebra": "p0_20", "Label": 3, "Dataset": "train", "All RHLV": 0.1, "Pre RHLV": -1e-20,
     "Mid RHLV": 1 / 3, "Post RHLV": 123456789.125, "Relative Height Label": float("nan")},
    {"Vertebra": "a,b \"q\"", "Label": 0, "Dataset": "val", "All RHLV": 2.5e-05,
     "Pre RHLV": 0.0, "Mid RHLV": -7.0, "Post RHLV": 1e16, "Relative Height Label": 0.9},
]


def test_csv_written_as_pandas_writes_it(tmp_path):
    pd.DataFrame(ROWS).to_csv(tmp_path / "pandas.csv", index=False)
    path = table.write_rows(ROWS, str(tmp_path / "port.xlsx"))
    assert path == str(tmp_path / "port.csv")
    assert (tmp_path / "port.csv").read_bytes() == (tmp_path / "pandas.csv").read_bytes()
    pd.testing.assert_frame_equal(pd.read_csv(path), pd.DataFrame(ROWS))


def test_csv_read_as_pandas_reads_it(tmp_path):
    jrhlv.write_rows(ROWS, str(tmp_path / "jax.xlsx"))  # no openpyxl: writes jax.csv
    got = table.read_rows(str(tmp_path / "jax.xlsx"))
    want = pd.read_csv(tmp_path / "jax.csv")
    assert list(got[0]) == list(want.columns) and len(got) == len(want)
    for k in want.columns:
        vals = [r[k] for r in got]
        kind = {"i": int, "f": float}.get(want[k].dtype.kind, str)
        assert all(type(v) is kind for v in vals), k
        if kind is str:
            assert vals == list(want[k]), k
        else:
            np.testing.assert_array_equal(np.array(vals, float), want[k].to_numpy(float),
                                          err_msg=k)
    with pytest.raises(FileNotFoundError):
        table.read_rows(str(tmp_path / "missing.xlsx"))


def test_merge_on_equals_pandas_merge():
    sag = [dict(r, Vertebra=v) for r, v in zip(ROWS * 2, ("b", "a", "c", "a"))]
    cor = [dict(ROWS[1], Vertebra=v, **{"Pre RHLV": i}) for i, v in enumerate(("a", "d", "b"))]
    cols = ["Vertebra", "Pre RHLV", "Mid RHLV", "Post RHLV"]
    want = pd.DataFrame(sag).merge(pd.DataFrame(cor)[cols], on="Vertebra",
                                   suffixes=("_sag", "_cor"))
    got = table.merge_on(sag, cor, "Vertebra", cols, suffixes=("_sag", "_cor"))
    pd.testing.assert_frame_equal(pd.DataFrame(got), want)
    assert table.columns(got) == list(want.columns)
    assert os.path.basename(table.csv_path("x/t.xlsx")) == "t.csv"
