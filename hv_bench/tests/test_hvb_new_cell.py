"""A cell, a traffic, a configuration and a per-layer metric defined only by
new files and new BENCHMARK.json entries load and run, with no edit to a
file the benchmark has."""

import json

from hv_bench import run


def test_cell_from_new_files_only(tiny_root):
    hv = tiny_root / "hv_bench"
    cfg = json.loads((hv / "configs" / "healthivert-bf16.json").read_text())
    cfg["name"] = "healthivert-new"
    (hv / "configs" / "healthivert-new.json").write_text(json.dumps(cfg))
    traffic = json.loads((hv / "traffic" / "cohort-3d.json").read_text())
    traffic["vert_ids"] = [20, 21]
    (hv / "traffic" / "cohort-two.json").write_text(json.dumps(traffic))
    spec = json.loads((hv / "workloads" / "synth3d-bf16.json").read_text())
    (hv / "workloads" / "synth-two.json").write_text(json.dumps(spec))
    (hv / "metrics" / "synth.patients_seen.py").write_text(
        "def read(layer):\n    return float(layer['slices']) if layer.get('slices') else None\n")
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "healthivert-new", "source": "https://example.org",
                             "file": "hv_bench/configs/healthivert-new.json", "reduced": [],
                             "why": "a test"})
    bench["workloads"].append({"name": "synth-two", "config": "healthivert-new",
                               "traffic": "cohort-two", "chips": 1, "why": "a test"})
    e2e = next(m for m in bench["end_to_end"] if m["name"] == "synth_vertebrae_per_s")
    e2e["workloads"].append("synth-two")
    bench["per_layer"].append({"name": "synth.patients_seen", "unit": "slices",
                               "better": "higher", "source": "program_counter",
                               "layer": "3D driver", "moves": "synth_vertebrae_per_s",
                               "workloads": ["synth-two"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))
    r = run.main(["--workload", "synth-two", "--seed", "5", "--seconds", "0.5", "--trace", "1"],
                 device="cpu", root=tiny_root)
    assert r["attempted"] % 2 == 0 and r["metrics"]["synth.patients_seen"]["value"] > 0
    assert "synth.generator_mfu" not in r["metrics"]  # listed for the other cell only
