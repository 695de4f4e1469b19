"""Readings that set a cell's limits, outside the benchmark's own runs: the
numbers its check compares, for the system as configured and for the
control (the nearest lower precision), on many seeds in one process.

    python3 -m hv_bench.controls --workload <cell> --seeds 1 2 3 ... \\
        [--variants none int8] [--out FILE]

prints one JSON line {variant: {seed: {number: reading}}} (and writes it
to FILE). A training seed is a whole run at BENCHMARK.json's run_seconds.
The drivers' `readings` say what each variant plants.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import json
import sys
from pathlib import Path

from .run import Cell, cache_dirs, load_json


def main(argv=None, device=None, root=None):
    ap = argparse.ArgumentParser(description="limit readings of a cell")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--variants", nargs="+", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    root = Path(root or Path.cwd())
    cache_dirs(root)
    bench = load_json(root / "BENCHMARK.json")
    device = device or "cuda"
    cell = Cell(bench, args.workload, args.seeds[0], bench["run_seconds"], False, device, root)
    variants = [None if v == "none" else v for v in
                (args.variants or ["none", cell.spec["control"]])]
    driver = importlib.import_module(f"hv_bench.drivers.{cell.traffic['driver']}")
    with contextlib.redirect_stdout(sys.stderr):
        out = driver.readings(cell, args.seeds, variants)
    line = json.dumps(out)
    if args.out:
        Path(args.out).write_text(line + "\n")
    print(line, flush=True)
    return out


if __name__ == "__main__":
    main()
