"""The program span recorder's cost, off and on, and the split it gives,
outside the benchmark's own runs (no cell runs this):

    python3 -m hv_bench.span_cost --seed <n> [--reps 5] [--blocks 12] [--out FILE]

prints one JSON line (and writes it to FILE):

- `loop_ns`: one pass of an empty loop; `span_ns_off`, `record_ns_off`,
  `span_ns_on`, `record_ns_on`: one call site less that, as the 3D driver
  opens a span (`span(name, pass=...)` around an empty body) and as the
  training loop records one (`record(name, start, end)`), the mean of
  CALLS calls; on, the recorder is drained every DRAIN calls, outside the
  timing;
- `synth_traced_patient_s`: synth3d-bf16's traced patient, the host time
  of its MEASURED range as the driver's `_traced` takes it, with the
  recorder on (for both of `_traced`'s patients) and off in turn (`--reps`
  each); `synth_split_pct`: each `hv.3d.*` span name's self time in the
  traced patient as a share of that host time, the median over the runs
  with the recorder on;
- `train_block8_s`: train-recipe-bf16's recipe from its weights for
  `--seed`, blocks of 8 steps between two device syncs after the
  traffic's warm-up steps, the recorder on and off in turn (`--blocks`
  each; a block may hold an eval epoch or a save, as the recipe's cadence
  puts them); `train_split_pct`: each `hv.train.*` span name's self time
  over the blocks with the recorder on, as a share of their seconds;

and each list's median.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import sys
import time
from pathlib import Path

from . import spines
from .run import Cell, cache_dirs, load_json

CALLS = 200_000
DRAIN = 10_000


def _per_call(body, n):
    t = time.perf_counter_ns()
    for _ in range(n):
        body()
    return (time.perf_counter_ns() - t) / n


def call_sites(calls=CALLS):
    """Nanoseconds a call site, off and on."""
    from healthivert_tpu_torch.utils import spans

    def opened():
        with spans.span("hv.cost", **{"pass": "upper"}):
            pass

    def recorded():
        spans.record("hv.cost", 1, 2)

    chunk = min(DRAIN, calls)
    out = {"loop_ns": _per_call(lambda: None, calls)}
    for on in (False, True):
        (spans.enable if on else spans.disable)()
        for name, body in (("span", opened), ("record", recorded)):
            ns = []
            for _ in range(calls // chunk):
                ns.append(_per_call(body, chunk))
                spans.drain()
            out[f"{name}_ns_{'on' if on else 'off'}"] = statistics.mean(ns) - out["loop_ns"]
    spans.disable()
    return out


def _pct(own, seconds):
    return {k: 100.0 * v / seconds for k, v in own.items()}


def synth_patients(root, seed, reps, device):
    """The traced patient's host seconds, recorder on and off in turn, and
    the split of the patients traced with it on."""
    from healthivert_tpu_torch.engine import infer3d
    from healthivert_tpu_torch.ops import attention_cuda
    from healthivert_tpu_torch.utils import spans

    from .drivers import synth3d

    cell = Cell(load_json(root / "BENCHMARK.json"), "synth3d-bf16", seed, 0.0, True, device,
                root)
    tr = cell.traffic
    if device != "cpu":
        attention_cuda.load_library()
    gen, cfg = synth3d.build(cell)
    call = lambda vols: infer3d.synthesize_volumes(
        gen, cfg, vols, batch_size=tr["slice_batch"], use_bf16=cfg.compute_dtype != "float32",
        axis=tr["axis"], device=device)
    for vols in spines.patients(spines.seed_stream(seed, 1), tr["warmup_patients"], tr, device):
        call(vols)
    out, splits = {"on": [], "off": []}, []
    for r in range(2 * reps):
        on = r % 2 == 0
        (spans.enable if on else spans.disable)()
        try:
            window_s = synth3d._traced(cell, call)["window"].window_s
        finally:
            spans.disable()
        records = spans.drain()
        out["on" if on else "off"].append(window_s)
        if on:
            # the traced patient is the last call `_traced` made
            last = [rec for rec in records if rec.rid == infer3d.synthesize_volumes.calls]
            lo, hi = min(rec.start for rec in last), max(rec.end for rec in last)
            splits.append(_pct(spans.self_times(last, lo, hi), window_s))
    split = {k: statistics.median(s.get(k, 0.0) for s in splits) for k in splits[0]}
    return out, split


def train_blocks(root, seed, blocks, device):
    """Seconds of 8-step blocks of the recipe, recorder on and off in turn,
    and the split of the blocks with it on."""
    from healthivert_tpu_torch.ops import attention_cuda
    from healthivert_tpu_torch.utils import spans

    from . import weights
    from .drivers import train

    cell = Cell(load_json(root / "BENCHMARK.json"), "train-recipe-bf16", seed, 0.0, False,
                device, root)
    if device != "cpu":
        attention_cuda.load_library()
    train.precision(cell)
    w0 = weights.make(train.template(cell), seed, device)
    first, out, mark, own = cell.traffic["warmup_steps"], {"on": [], "off": []}, {}, {}

    def on_step(step, losses):
        if step < first or (step - first) % 8:
            return
        train._sync(device)
        now, now_ns = time.perf_counter(), time.time_ns()
        records = spans.drain()
        if "t" in mark:
            on = spans.enabled()
            out["on" if on else "off"].append(now - mark["t"])
            for k, v in (spans.self_times(records, mark["ns"], now_ns) if on else {}).items():
                own[k] = own.get(k, 0.0) + v
        spans.disable()
        if len(out["off"]) == blocks:
            raise train._Stop
        (spans.enable if len(out["on"]) == len(out["off"]) else spans.disable)()
        mark.update(t=time.perf_counter(), ns=time.time_ns())

    try:
        train._train(cell, w0, on_step, {})
    finally:
        spans.disable()
        spans.drain()
    return out, _pct(own, sum(out["on"]))


def main(argv=None, device=None, root=None):
    ap = argparse.ArgumentParser(description="the span recorder's cost, off and on")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--blocks", type=int, default=12)
    ap.add_argument("--calls", type=int, default=CALLS)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    root = Path(root or Path.cwd())
    cache_dirs(root)
    device = device or "cuda"
    with contextlib.redirect_stdout(sys.stderr):
        out = call_sites(args.calls)
        for key, (runs, split) in (
                ("synth", synth_patients(root, args.seed, args.reps, device)),
                ("train", train_blocks(root, args.seed, args.blocks, device))):
            name = "synth_traced_patient_s" if key == "synth" else "train_block8_s"
            out[name] = runs
            for side, values in runs.items():
                out[f"{name}_{side}_median"] = statistics.median(values)
            out[f"{key}_split_pct"] = split
    line = json.dumps(out)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line)
    return out


if __name__ == "__main__":
    main()
