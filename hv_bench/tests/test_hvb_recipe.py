"""The benchmark's arithmetic of the recipe's cadences: which steps are
followed by an eval epoch or a checkpoint save (these name the traced host
spans and count the eval work in a traced window)."""

import json
from types import SimpleNamespace

from hv_bench.drivers import train
from hv_bench.tests.conftest import REPO


def _cell():
    hv = REPO / "hv_bench"
    read = lambda *p: json.loads(hv.joinpath(*p).read_text())
    return SimpleNamespace(config=read("configs", "healthivert-bf16.json"),
                           traffic=read("traffic", "recipe.json"))


def test_cadences_of_the_recipe():
    cell = _cell()
    marked = {s: train._span_name(cell, s) for s in range(1, 320)
              if train._span_name(cell, s) != "hv.step"}
    # two steps an epoch from epoch 49: evals after epochs 50, 100, 150, 200;
    # epoch saves at 100 and 200; 'latest' every 5000 examples
    assert marked == {4: "hv.step+eval", 104: "hv.step+save+eval", 157: "hv.step+save",
                      204: "hv.step+eval", 304: "hv.step+save+eval", 313: "hv.step+save"}


def test_set_up_runs_one_eval_epoch():
    cell = _cell()
    assert train._evals_between(cell, 1, cell.traffic["warmup_steps"]) == 1
    assert train._evals_between(cell, 6, 104) == 0 and train._evals_between(cell, 6, 105) == 1
