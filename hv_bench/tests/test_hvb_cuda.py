"""On the card, at each cell's own size: the control (the nearest lower
precision, see hv_bench/controls.py) comes out not correct by at least one
of the cell's numbers, while the system as configured stays within every
limit. Marked `cuda`; skips without a card."""

import json

import pytest

from hv_bench.run import Cell
from hv_bench.tests.conftest import REPO

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
SEED = 2 ** 32 + 101


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_control_fails_and_system_holds(card, cell):
    import importlib

    c = Cell(BENCH, cell, SEED, BENCH["run_seconds"], False, card, REPO)
    driver = importlib.import_module(f"hv_bench.drivers.{c.traffic['driver']}")
    got = driver.readings(c, [SEED], [None, c.spec["control"]])
    lim = c.spec["limits"]
    system, control = got["None"][SEED], got[c.spec["control"]][SEED]
    assert all(system[k] <= lim[k] for k in lim), (system, lim)
    assert any(control[k] > lim[k] for k in lim), (control, lim)
