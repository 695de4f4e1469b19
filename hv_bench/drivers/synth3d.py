"""The 3D synthesis as a cohort is walked: one caller runs whole patients
back to back through `engine.infer3d.synthesize_volumes`, as the 3D CLI's
`synthesize_group` calls it (a patient's vertebrae sharing the three
passes), each patient a fresh synthetic spine from the seed.

Traffic keys: shape, vert_ids, vert_height, gap, fracture (the fractured
vertebra's height fraction, uniform in [lo, hi]), axis, slice_batch,
max_vertebrae_per_s (the patients made before the window are enough for
--seconds at this rate, several times today's; no two calls of a window
may see the same volumes, so a window that needs more reuses them and is
not correct: the check `reused_patients`, limit 0), warmup_patients,
compare ({"patients": k,
"among_first": n}: the
k patients, drawn from the seed among the first n of the window, whose
volumes the reference recomputes).
"""

from __future__ import annotations

import gc
import math
import sys
import time

import numpy as np
import torch

from .. import check, spines, trace, work
from ..reference import infer3d as ref3d
from ..reference import model as ref


def _sync(device):
    if device != "cpu":
        torch.cuda.synchronize()


def build(cell, control=None):
    """The system under test: the configuration's generator, loaded by the
    system from the shipped weights, in the configuration's precision, or
    the control's (control="int8": the system's own int8 path)."""
    from healthivert_tpu_torch.engine.checkpoint import load_generator
    from healthivert_tpu_torch.models.pix2pix import Pix2PixConfig

    m = cell.config["model"]
    dtype = control or cell.config["compute_dtype"]
    cfg = Pix2PixConfig(ngf=m["ngf"], image_size=cell.traffic["shape"][0], compute_dtype=dtype)
    gen = load_generator(cell.root / cell.config["generator_weights"], cfg, device=cell.device)
    return gen, cfg


def pool_size(cell):
    """Patients enough for the window at max_vertebrae_per_s."""
    tr = cell.traffic
    return math.ceil(cell.seconds * tr["max_vertebrae_per_s"] / len(tr["vert_ids"])) + 1


def sample_of(cell, seed):
    """The patients whose volumes the reference recomputes: drawn from the
    seed among the window's first ones."""
    pick = np.random.default_rng(spines.seed_stream(seed, 2))
    c = cell.traffic["compare"]
    return sorted(pick.choice(c["among_first"], c["patients"], replace=False).tolist())


def run(cell, t0):
    """One run: set-up, the window, with --trace 1 the profiled patient,
    then the comparison."""
    from healthivert_tpu_torch.engine import infer3d
    from healthivert_tpu_torch.ops import attention_cuda

    tr, dev = cell.traffic, cell.device
    if dev != "cpu":
        attention_cuda.load_library()
    gen, cfg = build(cell)
    use_bf16 = cfg.compute_dtype != "float32"
    call = lambda vols: infer3d.synthesize_volumes(
        gen, cfg, vols, batch_size=tr["slice_batch"], use_bf16=use_bf16, axis=tr["axis"],
        device=dev)
    pool = spines.patients(cell.seed, pool_size(cell), tr, dev)
    warm = spines.patients(spines.seed_stream(cell.seed, 1), tr["warmup_patients"], tr, dev)
    sample = set(sample_of(cell, cell.seed))
    for vols in warm:
        call(vols)
    _sync(dev)
    if dev != "cpu":
        torch.cuda.reset_peak_memory_stats()
    infer3d._forward.dispatches = 0
    setup_s = time.perf_counter() - t0

    kept, done, i, took = {}, 0, 0, []
    start = time.perf_counter()
    while True:
        vols = pool[i % len(pool)]
        res = call(vols)
        took.append(time.perf_counter() - start - sum(took))
        if i in sample:
            kept[i] = res
        done, i = done + 1, i + 1
        if time.perf_counter() - start >= cell.seconds:
            break
    _sync(dev)
    window_s = time.perf_counter() - start
    dispatches = infer3d._forward.dispatches
    reused = max(0, done - len(pool))
    if reused:
        print(f"hv_bench: the window ran {done} patients, {len(pool)} made for "
              f"{tr['max_vertebrae_per_s']} vertebrae/s: {reused} reused", file=sys.stderr)
    n_vert = sum(len(pool[k % len(pool)]) for k in range(done))
    print("hv_bench: patient seconds " + " ".join(f"{t:.3f}" for t in took), file=sys.stderr)

    layer = {}
    if cell.trace:
        layer = _traced(cell, call)
    peak = torch.cuda.max_memory_allocated() if dev != "cpu" else 0
    del gen, call
    gc.collect()
    if dev != "cpu":
        torch.cuda.empty_cache()

    slices = sum(ref3d.count_jobs(pool[k % len(pool)], tr["axis"]) for k in range(done))
    w = cell.config["work"]
    dtype = cell.config["compute_dtype"]
    if cell.trace:
        layer.update(unit_busy_s=layer["window"].busy_s, unit_s=window_s / done)
    layer.update(slices=slices, dispatches=dispatches, window_s=window_s,
                 slice_flops=w["slice_fwd_flops"], peak_flops=work.PEAK_FLOPS[dtype])
    t_ref = time.perf_counter()
    checks = compare(cell, {k: pool[k] for k in kept}, kept)
    checks["reused_patients"] = (reused, 0)
    print(f"hv_bench: the comparison took {time.perf_counter() - t_ref:.1f} s", file=sys.stderr)
    out = dict(attempted=n_vert, failed=0, memory_peak_bytes=peak, layer=layer,
               e2e={"setup_s": setup_s, "synth_vertebrae_per_s": n_vert / window_s},
               checks=checks, correct=check.passed(checks))
    if cell.trace:
        out["breakdown"] = check.breakdown(layer["window"])
    return out


def _traced(cell, call):
    """Profile one patient call after an unmeasured one, both new patients
    (see trace.py)."""
    from torch.profiler import profile

    for attempt in range(trace.TRIES):
        warm_vols, vols = spines.patients(spines.seed_stream(cell.seed, 3 + attempt), 2,
                                          cell.traffic, cell.device)
        _sync(cell.device)
        spans = trace.Spans()
        with profile(activities=trace.activities(cell.device)) as prof:
            with spans("hv.patient"):
                call(warm_vols)
            _sync(cell.device)
            with spans(trace.MEASURED), spans("hv.patient"):
                call(vols)
                _sync(cell.device)
        win = trace.reduce(trace.from_profiler(prof) + spans.events)
        if not win.lost:
            break
        print(f"hv_bench: profiled patient lost {win.lost} kernel records; again",
              file=sys.stderr)
    else:
        raise RuntimeError(f"profiler lost kernel records in each of {trace.TRIES} windows")
    hd, wd, c = work.attention_grid(cell.traffic["shape"][0], cell.config["model"]["ngf"])
    dtype = cell.config["compute_dtype"]
    flops, nbytes = work.attention_fwd(ref3d.count_jobs(vols, cell.traffic["axis"]), hd, wd,
                                       c, dtype)
    return dict(window=win, attention_least_s=work.least_s(flops, nbytes, dtype))


def reference_generator(cell):
    """The plain float32 generator with the shipped weights, read from the
    weights file itself."""
    gen = ref.Generator(cell.config["model"]["ngf"])
    gen.load_state_dict(ref.npz_state_dict(cell.root / cell.config["generator_weights"]))
    return gen.to(cell.device).eval()


def gaps(cell, gen_ref, inputs, kept):
    """{patient: volume_gaps} of the system's volumes against the
    reference's recomputed from the same inputs."""
    tr = cell.traffic
    out = {}
    with check.exact_float32():
        for k in sorted(kept):
            want = ref3d.synthesize(gen_ref, inputs[k], cell.device, tr["slice_batch"], tr["axis"])
            out[k] = check.volume_gaps(kept[k], want, inputs[k], tr["axis"])
            print(f"hv_bench: patient {k}: " + " ".join(f"{a} {b!r}" for a, b in out[k].items()),
                  file=sys.stderr)
    return out


def compare(cell, inputs, kept):
    """The numbers held to the cell's limits, each the largest over the
    sampled patients: the mean |CT difference| over the slices the synthesis
    processed, and the median over those slices of each slice's mean."""
    per = gaps(cell, reference_generator(cell), inputs, kept)
    keys = tuple(cell.spec["limits"])
    worst = {k: max((d[k] for d in per.values()), default=float("nan")) for k in keys}
    return {k: (worst[k], cell.spec["limits"][k]) for k in keys}


def readings(cell, seeds, variants):
    """The compared numbers of each seed's sampled patients for each
    variant (None: the system as configured; "int8": its int8 path, the
    control), in one process: {variant: {seed: worst gaps}}."""
    from healthivert_tpu_torch.engine import infer3d
    from healthivert_tpu_torch.ops import attention_cuda

    tr, dev = cell.traffic, cell.device
    if dev != "cpu":
        attention_cuda.load_library()
    gens = {v: build(cell, v) for v in variants}
    gen_ref = reference_generator(cell)
    out = {str(v): {} for v in variants}
    for seed in seeds:
        sample = sample_of(cell, seed)
        pool = spines.patients(seed, max(sample) + 1, tr, dev)
        inputs = {k: pool[k] for k in sample}
        for v, (gen, cfg) in gens.items():
            kept = {k: infer3d.synthesize_volumes(
                gen, cfg, inputs[k], batch_size=tr["slice_batch"], use_bf16=True,
                axis=tr["axis"], device=dev) for k in sample}
            per = gaps(cell, gen_ref, inputs, kept)
            out[str(v)][seed] = {key: max(d[key] for d in per.values())
                                 for key in per[sample[0]]}
            print(f"hv_bench: readings {v} seed {seed}: {out[str(v)][seed]}", file=sys.stderr)
    return out
