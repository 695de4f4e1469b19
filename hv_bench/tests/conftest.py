"""The benchmark's own tests: CPU tests at tiny sizes, and tests marked
`cuda` that need the card (they skip here; on the card:
`python3 -m pytest -p no:cacheprovider hv_bench/tests -m cuda`)."""

import json
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return "cuda"


TINY_SYNTH = dict(shape=[64, 64, 16], vert_ids=[19, 20, 21], vert_height=10, gap=4,
                  max_vertebrae_per_s=200, slice_batch=16,
                  compare={"patients": 2, "among_first": 2})
TINY_MODEL = dict(image_size=64, ndf=8)
TINY_RECIPE = dict(crop_size=64, ndf=8, batch_size=4, synthetic_cache=16)
TINY_TRAIN = dict(warmup_steps=4, trace_steps=3)


@pytest.fixture
def tiny_root(tmp_path):
    """A checkout-like root whose cells run at tiny sizes on the CPU: the
    benchmark's files with the configurations and traffic cut down."""
    src = REPO / "hv_bench"
    dst = tmp_path / "hv_bench"
    for sub in ("configs", "traffic", "workloads", "metrics"):
        shutil.copytree(src / sub, dst / sub)
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    (tmp_path / "healthivert_tpu_torch").mkdir()
    (tmp_path / "healthivert_tpu_torch" / "weights").symlink_to(
        REPO / "healthivert_tpu_torch" / "weights")
    for path in (dst / "configs").glob("*.json"):
        c = json.loads(path.read_text())
        c["model"].update(TINY_MODEL)
        c["recipe"].update(TINY_RECIPE)
        path.write_text(json.dumps(c))
    for path in (dst / "traffic").glob("*.json"):
        t = json.loads(path.read_text())
        t.update(TINY_SYNTH if t["driver"] == "synth3d" else TINY_TRAIN)
        path.write_text(json.dumps(t))
    return tmp_path
