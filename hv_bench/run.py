"""One run of one benchmark cell:

    python3 -m hv_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds BENCHMARK.json. The cell's entry
there names its configuration (hv_bench/configs/<config>.json) and its
traffic (hv_bench/traffic/<traffic>.json, whose "driver" names the module
of hv_bench/drivers/ that runs it); its limits and control are in
hv_bench/workloads/<cell>.json; each per-layer metric is read by
hv_bench/metrics/<metric>.py. A new cell, configuration, traffic or
per-layer metric is a new file and a new BENCHMARK.json entry.

A run sets up and warms the system, measures a window of --seconds, with
--trace 1 then profiles a short steady sub-window, reads the device's peak
memory, frees the system's state, holds what the window produced against
the plain reference, and prints its result as the last line of standard
output (the numbers compared, each beside its limit, are the last lines of
standard error and the last key of the result). It exits 2 without a
result when the card it asks for is missing, and 3 when a module of JAX
or of the JAX package is loaded once the window has closed.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()  # set-up is timed from here

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path.cwd()
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "healthivert_tpu")


def cache_dirs(root: Path):
    """Every build and kernel cache at a fixed place inside the checkout, so
    that only a cell's first run there builds (the system's own nvcc
    objects go to healthivert_tpu_torch/_build/, a path it fixes itself)."""
    base = root / ".hv_bench_cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(base / sub)


def forbidden_modules():
    """Loaded modules whose whole top-level name is JAX's or the JAX
    package's (the system's own package name begins with the latter's)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


class Cell:
    """What a driver needs: the cell's entries and files, its per-layer
    metrics, the run's arguments and the device."""

    def __init__(self, bench: dict, workload: str, seed: int, seconds: float, trace: bool,
                 device: str, root: Path):
        cells = {w["name"]: w for w in bench["workloads"]}
        if workload not in cells:
            raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
        self.entry = cells[workload]
        self.name, self.seed, self.seconds, self.trace = workload, seed, seconds, trace
        self.device, self.root = device, root
        configs = {c["name"]: c for c in bench["configs"]}
        self.config = load_json(root / configs[self.entry["config"]]["file"])
        self.traffic = load_json(root / "hv_bench" / "traffic" / f"{self.entry['traffic']}.json")
        self.spec = load_json(root / "hv_bench" / "workloads" / f"{workload}.json")
        self.end_to_end = [m for m in bench["end_to_end"]
                           if workload in m.get("workloads", [workload])]
        reported = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in bench["per_layer"]
                          if workload in m.get("workloads", [workload]) and m["moves"] in reported]


def load_metric(root: Path, name: str):
    """The reader module of a per-layer metric: hv_bench/metrics/<name>.py."""
    path = root / "hv_bench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"hv_bench.metrics.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def device_info(device: str, chips: int, peak: int):
    import torch

    if device == "cpu":
        return {"platform": "cpu", "kind": "cpu", "count": chips, "memory_peak_bytes": peak}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
            "memory_peak_bytes": peak}


def card_note():
    """The card's name and power limit, for the earlier lines of the run."""
    import subprocess

    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"


def finite(x):
    return x is not None and isinstance(x, (int, float)) and math.isfinite(x)


def main(argv=None, device=None, root=None, bench=None):
    """Run one cell; returns the result dict (also printed). device="cpu"
    skips the look for a card (the CPU tests drive a run so)."""
    ap = argparse.ArgumentParser(description="one run of one benchmark cell")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = Path(root or ROOT)
    cache_dirs(root)
    bench = bench if bench is not None else load_json(root / "BENCHMARK.json")
    import torch

    chips = next((w.get("chips", 1) for w in bench["workloads"] if w["name"] == args.workload), 1)
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            print(f"hv_bench: the cell needs {chips} CUDA device(s), found "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            sys.exit(2)
        device = "cuda"
        print(f"hv_bench: card {card_note()}", file=sys.stderr)
    cell = Cell(bench, args.workload, args.seed, args.seconds, bool(args.trace), device, root)
    driver = importlib.import_module(f"hv_bench.drivers.{cell.traffic['driver']}")
    # the system prints its own progress; the last line of stdout is ours
    with contextlib.redirect_stdout(sys.stderr):
        out = driver.run(cell, T0)
    bad = forbidden_modules()
    if bad:
        print(f"hv_bench: loaded once the window closed: {bad}", file=sys.stderr)
        sys.exit(3)
    result = {"correct": out["correct"], "attempted": out["attempted"], "failed": out["failed"]}
    if cell.trace:
        metrics, patterns = {}, []
        for m in cell.per_layer:
            reader = load_metric(root, m["name"])
            patterns += [reader.KERNELS] if hasattr(reader, "KERNELS") else []
            value = reader.read(out["layer"])
            if finite(value):
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        result["metrics"] = metrics
        kernels = out["layer"]["window"].kernels
        free = {k: v for k, v in kernels.items() if not any(p.search(k) for p in patterns)}
        print(f"hv_bench: traced device s {sum(kernels.values())!r}, claimed by no metric's "
              f"kernel list {sum(free.values())!r}; largest unclaimed: "
              + "; ".join(f"{k[:80]} {v!r}" for k, v in
                          sorted(free.items(), key=lambda kv: -kv[1])[:5]), file=sys.stderr)
    else:
        result["metrics"] = {m["name"]: {"value": out["e2e"][m["name"]], "unit": m["unit"]}
                             for m in cell.end_to_end}
    dev = device_info(device, chips, out["memory_peak_bytes"])
    if cell.trace:
        dev.update(busy_s=out["layer"]["window"].busy_s, window_s=out["layer"]["window"].window_s)
        result["breakdown"] = out["breakdown"]
    result["device"] = dev
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in out["checks"].items()}
    for k, (v, lim) in out["checks"].items():
        print(f"check {k}: {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    gc.collect()
    return result


if __name__ == "__main__":
    main()
