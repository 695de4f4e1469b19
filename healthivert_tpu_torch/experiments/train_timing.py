"""Wall time per step of the port's training loop on the shipped recipe.

Runs `run_training` with the options of
checkpoints/pretrained_synthetic/train_opt.txt (batch 32, bf16, synthetic
data; --dtype float32 for the dtype the train CLI defaults to) on the card
for --warmup + --steps steps, times each step on the
host clock after a device synchronise, and prints one JSON line: each
step's ms, their mean and median, the attention's launches and the card's
name and power limit.

The step is bound by the host (kernel launches, the pageable batch copy),
so its time spreads between processes. To set two trees of the package
against each other, run this file from one tree with PYTHONPATH naming
each tree's root in turn, in the order A, B, B, A, in one session on one
card (it imports the package by its absolute name for that reason):

    PYTHONPATH=<tree> python3 healthivert_tpu_torch/experiments/train_timing.py
"""

from __future__ import annotations

import argparse
import json
import subprocess
import tempfile
import time
import types
from pathlib import Path

import numpy as np
import torch

import healthivert_tpu_torch
from healthivert_tpu_torch.engine.train_loop import run_training
from healthivert_tpu_torch.ops.attention_cuda import attention_v2, attention_v2_bwd

ROOT = Path(healthivert_tpu_torch.__file__).resolve().parents[1]
RECIPE = ROOT / "checkpoints" / "pretrained_synthetic" / "train_opt.txt"


def read_recipe(path=RECIPE):
    """The option namespace of a saved train_opt.txt ("name: value" lines,
    with a "[default: ...]" note where the value is not the default)."""
    opt = {}
    for line in Path(path).read_text().splitlines():
        if ":" not in line or line.startswith("-"):
            continue
        key, value = line.split(":", 1)
        value = value.split("[default:")[0].strip()
        for conv in (int, float):
            try:
                value = conv(value)
                break
            except ValueError:
                pass
        else:
            value = {"True": True, "False": False, "None": None}.get(value, value)
        opt[key.strip()] = value
    return types.SimpleNamespace(**opt)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--dtype", choices=("bfloat16", "float32"), default=None,
                    help="compute dtype in place of the recipe's")
    args = ap.parse_args(argv)
    opt = read_recipe()
    opt.checkpoints_dir = tempfile.mkdtemp(prefix="train_timing_")  # logs, checkpoints
    if args.dtype is not None:
        opt.compute_dtype = args.dtype
    marks = []

    def on_step(step, losses):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())

    attention_v2.launches = attention_v2_bwd.launches = 0
    run_training(opt, max_steps=args.warmup + args.steps, device="cuda", on_step=on_step)
    step_ms = [(b - a) * 1e3 for a, b in zip(marks[args.warmup - 1:-1], marks[args.warmup:])]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    result = {"package": str(ROOT), "batch": opt.batch_size, "dtype": opt.compute_dtype,
              "warmup_steps": args.warmup, "timed_steps": args.steps,
              "ms_per_step": float(np.mean(step_ms)), "median_ms": float(np.median(step_ms)),
              "step_ms": step_ms, "attention_launches": [attention_v2.launches,
                                                         attention_v2_bwd.launches],
              "nvidia_smi": smi}
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
