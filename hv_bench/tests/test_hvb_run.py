"""The command's contract on a machine without the card, and the shape of
a result line."""

import json
import subprocess
import sys

from hv_bench import run
from hv_bench.tests.conftest import REPO


def test_no_card_no_result():
    p = subprocess.run([sys.executable, "-m", "hv_bench.run", "--workload", "synth3d-bf16",
                        "--seed", str(2 ** 33), "--seconds", "1", "--trace", "0"],
                       cwd=REPO, capture_output=True, text=True, timeout=300,
                       env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_result_line_shape(tiny_root, capsys):
    r = run.main(["--workload", "synth3d-bf16", "--seed", "3", "--seconds", "0.5",
                  "--trace", "0"], device="cpu", root=tiny_root)
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(line) == r
    assert list(r)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(r)[-1] == "checks" and all(set(c) == {"value", "limit"}
                                           for c in r["checks"].values())
    assert set(r["metrics"]) == {"synth_vertebrae_per_s", "setup_s"}
    assert r["metrics"]["setup_s"]["unit"] == "s"


def test_traced_line_has_the_layer_metrics(tiny_root, capsys):
    r = run.main(["--workload", "train-recipe-f32", "--seed", "3", "--seconds", "0.5",
                  "--trace", "1"], device="cpu", root=tiny_root)
    assert "train_images_per_s" not in r["metrics"]
    assert "train.step_mfu" in r["metrics"]
    assert r["device"]["window_s"] > 0 and "busy_s" in r["device"]
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
