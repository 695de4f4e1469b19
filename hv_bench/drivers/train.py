"""The training recipe as researchers retrain it: `engine.train_loop.
run_training` with the recipe's options, parsed by the system's own
train-option parser as the train CLI parses them, in one call that the
benchmark drives through its `on_step` hook from the first step to the end
of the window (and, traced, through a profiled sub-window after it).

The networks start from the benchmark's seeded weights (hv_bench/
weights.py), loaded into the state the loop builds; logs and checkpoints go
under TMPDIR. The recipe's epochs, eval epochs and checkpoint saves that
fall in the window are part of it.

Traffic keys: driver, epoch_count (the first epoch's number: with the
recipe's eval cadence it sets when the set-up's eval epoch falls),
warmup_steps (steps before the window; the set-up runs its eval epoch
among them), trace_steps (steps in the profiled sub-window), eval_batch
and eval_examples (the eval split as the train CLI reads it).

The check follows the first three steps (set-up's, through the window's
own call and feed): each step's losses, the first gradient of every leaf as
the optimizers got it (from Adam's first moment after step 1), and each
leaf's change after step 3, parameters and buffers (BatchNorm statistics,
spectral-norm vectors), against the plain reference fed the same batches,
worked out again from the seed. It also follows the step that comes right
after the window in the same call (numbers prefixed "win_"): the state
before it is copied once the window has closed, and the reference takes
that one step from the copy (parameters, buffers and Adam's moments) on the
batch worked out again from the seed, at the recipe's learning rate for
that step's epoch; its losses, each leaf's gradient as Adam got it (from
the change of the first moment) and each leaf's change are compared.
"""

from __future__ import annotations

import gc
import shutil
import sys
import tempfile
import time

import numpy as np
import torch

from .. import check, trace, weights, work
from ..reference import data as ref_data
from ..reference import model as ref

LEAVES = ("gen", "d1", "d2", "d3")


class _Stop(Exception):
    """Raised by on_step to end run_training where the benchmark is done."""


def _sync(device):
    if device != "cpu":
        torch.cuda.synchronize()


def precision(cell, control=None):
    """TF32 for float32 convolutions and matmuls as the configuration states
    (control="tf32": on, PyTorch's own default for cuDNN)."""
    on = bool(cell.config.get("tf32")) or control == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


def argv(cell, run_dir):
    """The train CLI's command line of the configuration's recipe."""
    out = []
    for k, v in cell.config["recipe"].items():
        if isinstance(v, bool):
            out.append(f"--{k}" if v else f"--no-{k}")
        else:
            out += [f"--{k}", str(v)]
    tr = cell.traffic
    out += ["--name", "hv_bench", "--checkpoints_dir", run_dir, "--seed", str(cell.seed),
            "--epoch_count", str(tr["epoch_count"]),
            "--gpu_ids", "-1" if cell.device == "cpu" else "0"]
    return out


def options(cell, run_dir, with_eval=True):
    """(opt, opt_test) as the train CLI builds them."""
    from healthivert_tpu_torch.config.options import TestOptions, TrainOptions

    a = argv(cell, run_dir)
    opt = TrainOptions().parse(a)
    if not with_eval:
        return opt, None
    opt_test = TestOptions().parse(a, save=False, known_only=True)
    opt_test.batch_size = cell.traffic["eval_batch"]
    opt_test.serial_batches = True
    opt_test.phase = "test"
    opt_test.isTrain = False
    return opt, opt_test


def template(cell):
    m = cell.config["model"]
    return ref.Nets(m["ngf"], m["ndf"], m["n_layers_D"]).state_dict()


def leaf_items(nets):
    """{"gen.<key>": tensor} over the four networks' parameters and buffers."""
    return {f"{n}.{k}": t for n in LEAVES for k, t in nets[n].state_dict().items()}


class Recorder:
    """What the check reads of the system's steps: the losses of steps 1-3,
    every leaf's first gradient norm (Adam's first moment after step 1,
    over 1 - beta1) and every leaf's change norm after step 3; and, for the
    step after the window, the state before it (`snapshot`) and that step's
    losses, gradient norms and change norms (`window_step`)."""

    def __init__(self, w0, beta1):
        self.w0, self.beta1 = w0, beta1
        self.losses, self.grad, self.change = [], {}, {}
        self.snap, self.win = None, None

    def step(self, state, step, losses):
        if step <= 3:
            self.losses.append({k: v.detach().float().clone() for k, v in losses.items()})
        nets = dict(zip(LEAVES, (state.gen, state.d1, state.d2, state.d3)))
        if step == 1:
            opts = _opts(state)
            for n in LEAVES:
                for k, p in nets[n].named_parameters():
                    m = opts[n].state[p].get("exp_avg", torch.zeros(1))
                    self.grad[f"{n}.{k}"] = torch.linalg.vector_norm(m.float()) / (1 - self.beta1)
        if step == 3:
            for k, t in leaf_items(nets).items():
                self.change[k] = torch.linalg.vector_norm(t.detach().float() - self.w0[k])

    def snapshot(self, state, step):
        """The state after `step`: every leaf, and Adam's state of each
        parameter (moments and step count), copied on the device."""
        nets = dict(zip(LEAVES, (state.gen, state.d1, state.d2, state.d3)))
        opts = _opts(state)
        adam = {f"{n}.{k}": {a: v.detach().clone() for a, v in opts[n].state[p].items()}
                for n in LEAVES for k, p in nets[n].named_parameters() if p in opts[n].state}
        self.snap = dict(step=step, adam=adam, weights={
            k: t.detach().float().clone() for k, t in leaf_items(nets).items()})

    def window_step(self, state, step, losses):
        nets = dict(zip(LEAVES, (state.gen, state.d1, state.d2, state.d3)))
        opts = _opts(state)
        grad = {}
        for n in LEAVES:
            for k, p in nets[n].named_parameters():
                m = opts[n].state[p].get("exp_avg") if p in opts[n].state else None
                m0 = self.snap["adam"].get(f"{n}.{k}", {}).get("exp_avg")
                if m is None:
                    grad[f"{n}.{k}"] = torch.zeros(())
                    continue
                g = m.float() - (self.beta1 * m0.float() if m0 is not None else 0.0)
                grad[f"{n}.{k}"] = torch.linalg.vector_norm(g) / (1 - self.beta1)
        change = {k: torch.linalg.vector_norm(t.detach().float() - self.snap["weights"][k])
                  for k, t in leaf_items(nets).items()}
        losses = {k: v.detach().float().clone() for k, v in losses.items()}
        self.win = dict(step=step, losses=losses, grad=grad, change=change)

    def host(self):
        return [_floats(d) for d in self.losses], _floats(self.grad), _floats(self.change)

    def host_window(self):
        w = self.win
        return [_floats(w["losses"])], _floats(w["grad"]), _floats(w["change"])


def _floats(d):
    return {k: float(v) for k, v in d.items()}


def _opts(state):
    return dict(zip(LEAVES, (state.opt_g, state.opt_d1, state.opt_d2, state.opt_d3)))


def _train(cell, w0, on_step, box, with_eval=True):
    """run_training of the recipe, in the train CLI's options, from the
    weights w0 (loaded into the state the loop builds, which `box` keeps),
    until on_step raises _Stop; logs and checkpoints in a temporary
    directory that is removed afterwards."""
    from healthivert_tpu_torch.engine import train_loop

    original = train_loop.init_state

    def init_state(*args, **kwargs):
        state = original(*args, **kwargs)
        load(state, w0)
        box["state"] = state
        return state

    run_dir = tempfile.mkdtemp(prefix="hv_bench_train_")
    train_loop.init_state = init_state
    try:
        opt, opt_test = options(cell, run_dir, with_eval)
        train_loop.run_training(opt, opt_test, max_steps=None, device=cell.device,
                                on_step=on_step)
        raise RuntimeError("the recipe ended before the benchmark did")
    except _Stop:
        pass
    finally:
        train_loop.init_state = original
        shutil.rmtree(run_dir, ignore_errors=True)


def session(cell, t0):
    """Set-up through the first steps and an eval epoch, the window, the
    step after it, with --trace 1 the profiled steps. Returns the Recorder
    and what the result needs; the system's state is freed."""
    from healthivert_tpu_torch.ops import attention_cuda

    tr, dev = cell.traffic, cell.device
    if dev != "cpu":
        attention_cuda.load_library()
    precision(cell)
    w0 = weights.make(template(cell), cell.seed, dev)
    rec = Recorder(w0, cell.config["model"]["beta1"])
    box, marks, prof_state = {}, {}, {"phase": None}

    def on_step(step, losses):
        if step <= 3:
            rec.step(box["state"], step, losses)
        if step == tr["warmup_steps"]:
            _sync(dev)
            if dev != "cpu":
                torch.cuda.reset_peak_memory_stats()
            marks["setup_s"] = time.perf_counter() - t0
            marks["start"], marks["first"] = time.perf_counter(), step
        elif "start" in marks and "end" not in marks:
            if time.perf_counter() - marks["start"] >= cell.seconds:
                _sync(dev)
                marks["end"], marks["last"] = time.perf_counter(), step
                marks["peak"] = torch.cuda.max_memory_allocated() if dev != "cpu" else 0
                rec.snapshot(box["state"], step)
        elif "end" in marks and rec.win is None:
            rec.window_step(box["state"], step, losses)
            if not cell.trace:
                raise _Stop
            prof_state.update(phase="warm", t=time.perf_counter(), tries=0)
            _profile_start(prof_state, dev)
        elif "end" in marks:
            _profile_step(prof_state, step, cell, dev)

    try:
        _train(cell, w0, on_step, box)
    finally:
        _profile_close(prof_state)
    box.clear()
    gc.collect()
    if dev != "cpu":
        torch.cuda.empty_cache()
    return rec, marks, prof_state


def run(cell, t0):
    """One run: the session, then the comparison."""
    rec, marks, prof_state = session(cell, t0)
    window_s = marks["end"] - marks["start"]
    steps = marks["last"] - marks["first"]
    batch = cell.config["recipe"]["batch_size"]
    layer = _layer(cell, prof_state, steps, window_s) if cell.trace else {}
    t_ref = time.perf_counter()
    checks = compare(cell, rec)
    print(f"hv_bench: the comparison took {time.perf_counter() - t_ref:.1f} s", file=sys.stderr)
    out = dict(attempted=steps * batch, failed=0, memory_peak_bytes=marks["peak"], layer=layer,
               e2e={"setup_s": marks["setup_s"], "train_images_per_s": steps * batch / window_s,
                    "train_f32_images_per_s": steps * batch / window_s},
               checks=checks, correct=check.passed(checks))
    if cell.trace:
        out["breakdown"] = check.breakdown(layer["window"])
    return out


def load(state, w):
    """The benchmark's weights into the system's networks (by key)."""
    for n, net in zip(LEAVES, (state.gen, state.d1, state.d2, state.d3)):
        sd = {k[len(n) + 1:]: v for k, v in w.items() if k.startswith(n + ".")}
        missing = set(net.state_dict()) ^ set(sd)
        if missing:
            raise KeyError(f"{n}: the system's keys and the reference's differ: "
                           f"{sorted(missing)[:4]}")
        net.load_state_dict(sd)


# ------------------------------------------------------------------ the trace

def _profile_start(ps, dev):
    from torch.profiler import profile

    ps["prof"] = profile(activities=trace.activities(dev))
    ps["prof"].start()
    ps["spans"], ps["span"] = trace.Spans(), None


def _span(ps, name):
    """End the open step span, and open `name` (None: none)."""
    if ps["span"] is not None:
        ps["spans"].end(ps["span"])
    ps["span"] = name
    if name is not None:
        ps["spans"].start(name)


def _profile_step(ps, step, cell, dev):
    """The profiled sub-window: unmeasured steps for trace.WARM_S, then
    trace_steps steps inside trace.MEASURED, each step a host span; taken
    again while the profiler lost kernel records."""
    if ps["phase"] == "warm":
        _span(ps, _span_name(cell, step))
        if time.perf_counter() - ps["t"] >= trace.WARM_S:
            _span(ps, None)
            _sync(dev)
            ps["spans"].start(trace.MEASURED)
            ps.update(phase="measured", first=step)
            _span(ps, _span_name(cell, step))
        return
    if step - ps["first"] < cell.traffic["trace_steps"]:
        _span(ps, _span_name(cell, step))
        return
    _sync(dev)
    _span(ps, None)
    ps["spans"].end(trace.MEASURED)
    ps["prof"].stop()
    ps["window"] = trace.reduce(trace.from_profiler(ps["prof"]) + ps["spans"].events)
    ps.update(prof=None, last=step, phase="done")
    if ps["window"].lost and ps["tries"] + 1 < trace.TRIES:
        print(f"hv_bench: profiled steps lost {ps['window'].lost} kernel records; again",
              file=sys.stderr)
        ps.update(phase="warm", t=time.perf_counter(), tries=ps["tries"] + 1)
        _profile_start(ps, dev)
        return
    if ps["window"].lost:
        raise RuntimeError(f"profiler lost kernel records in each of {trace.TRIES} windows")
    raise _Stop


def _profile_close(ps):
    if ps.get("prof") is not None:
        ps["prof"].stop()


def _span_name(cell, step):
    """The host span from on_step(step) to on_step(step + 1): the next step,
    after the checkpoint saves and the eval epoch that the recipe's
    cadences put after `step`."""
    r, tr = cell.config["recipe"], cell.traffic
    b, per = r["batch_size"], tr["examples_per_epoch"] // r["batch_size"]
    epoch = tr["epoch_count"] + step // per - 1 if step % per == 0 else None
    extra = [name for name, due in (
        ("save", step * b % r["save_latest_freq"] < b
         or epoch is not None and epoch % r["save_epoch_freq"] == 0),
        ("eval", _evals_between(cell, step, step + 1) > 0)) if due]
    return "hv.step" + "".join("+" + e for e in extra)


def _evals_between(cell, first, last):
    """Eval epochs the loop ran between the on_step calls of steps `first`
    and `last`: after each step that ends an epoch (examples_per_epoch /
    batch steps, numbered from epoch_count) whose number the recipe's
    eval_freq divides."""
    r, tr = cell.config["recipe"], cell.traffic
    per = tr["examples_per_epoch"] // r["batch_size"]
    ends = [s for s in range(first, last) if s % per == 0]
    return sum((tr["epoch_count"] + s // per - 1) % r["eval_freq"] == 0 for s in ends)


def _layer(cell, ps, steps, window_s):
    """The per-layer inputs: the traced window and the work of its steps."""
    r, m, w = cell.config["recipe"], cell.config["model"], cell.config["work"]
    dtype = cell.config["compute_dtype"]
    k = ps["last"] - ps["first"]
    evals = _evals_between(cell, ps["first"], ps["last"])
    hd, wd, c = work.attention_grid(m["image_size"], m["ngf"])
    b, ev = r["batch_size"], cell.traffic["eval_examples"]
    f1, b1 = work.attention_fwd(b, hd, wd, c, dtype)
    f2, b2 = work.attention_bwd(b, hd, wd, c, dtype)
    f3, b3 = work.attention_fwd(ev, hd, wd, c, dtype)
    attn = work.least_s(k * (f1 + f2) + evals * f3, k * (b1 + b2) + evals * b3, dtype)
    conv_flops = k * b * w["example_conv_flops"] + evals * ev * w["slice_fwd_conv_flops"]
    conv = work.least_s(conv_flops, k * b * w["example_conv_elems"] * work.ESIZE[dtype], dtype)
    return dict(window=ps["window"], attention_least_s=attn, conv_least_s=conv,
                unit_busy_s=ps["window"].busy_s / k, unit_s=window_s / steps,
                images=steps * b, window_s=window_s, example_flops=w["example_flops"],
                peak_flops=work.PEAK_FLOPS[dtype])


# ------------------------------------------------------------- the reference

def _reference(cell, quant, w):
    """The plain reference's networks in w's state, and their Adam
    optimizers."""
    m = cell.config["model"]
    nets = ref.Nets(m["ngf"], m["ndf"], m["n_layers_D"], quant=quant)
    nets.load_state_dict(w)
    nets.to(cell.device).train()
    opts = [torch.optim.Adam(getattr(nets, n).parameters(), lr=m["lr"], betas=(m["beta1"], 0.999),
                             eps=1e-8) for n in LEAVES]
    return nets, opts


def _step(cell, nets, opts, batch, lr, half, tf32):
    m = cell.config["model"]
    if half:
        batch = {k: v[: len(v) // 2] for k, v in batch.items()}
    tb = {k: torch.from_numpy(np.ascontiguousarray(v)).to(cell.device) for k, v in batch.items()}
    cfg = {"image_size": m["image_size"], "lambda_L1": m["lambda_L1"]}
    with check.exact_float32(tf32=tf32):
        losses = ref.train_step(nets, opts, tb, lr, cfg)
    return {k: float(v) for k, v in losses.items()}


def _grad_norms(nets):
    return {f"{n}.{k}": float(torch.linalg.vector_norm(p.grad)) if p.grad is not None else 0.0
            for n in LEAVES for k, p in getattr(nets, n).named_parameters()}


def _change_norms(nets, w):
    items = {f"{n}.{k}": t for n in LEAVES for k, t in getattr(nets, n).state_dict().items()}
    return {k: float(torch.linalg.vector_norm(t.float() - w[k])) for k, t in items.items()}


def reference_steps(cell, quant=None, half=False, tf32=False):
    """(losses of steps 1-3, first gradient norms, change norms after step
    3) of the plain reference from the benchmark's weights on the recipe's
    first batches, worked out again from the seed. Variants in the system's
    place: quant="int8", in int8 (the bf16 configuration's control);
    tf32=True, with TF32 (the float32 one's); half=True, the second half of
    each batch dropped (a fault)."""
    r = cell.config["recipe"]
    w0 = weights.make(template(cell), cell.seed, cell.device)
    nets, opts = _reference(cell, quant, w0)
    feed = ref_data.batches(cell.seed, 3, r["batch_size"], r["synthetic_cache"], r["crop_size"])
    losses, grad = [], {}
    for i, b in enumerate(feed, start=1):
        losses.append(_step(cell, nets, opts, b, lr_at(cell, i), half, tf32))
        if i == 1:
            grad = _grad_norms(nets)
    return losses, grad, _change_norms(nets, w0)


def reference_window_step(cell, snap, quant=None, half=False, tf32=False):
    """([losses], gradient norms, change norms) of the plain reference's one
    step from the system's state before the step after the window (`snap`,
    see Recorder.snapshot) on that step's batch, worked out again from the
    seed; variants as for reference_steps."""
    r, step = cell.config["recipe"], snap["step"] + 1
    nets, opts = _reference(cell, quant, snap["weights"])
    for n, o in zip(LEAVES, opts):
        for k, p in getattr(nets, n).named_parameters():
            if f"{n}.{k}" in snap["adam"]:
                o.state[p] = {a: v.clone() for a, v in snap["adam"][f"{n}.{k}"].items()}
    (b,) = ref_data.batches(cell.seed, 1, r["batch_size"], r["synthetic_cache"], r["crop_size"],
                            first=step)
    losses = _step(cell, nets, opts, b, lr_at(cell, step), half, tf32)
    return [losses], _grad_norms(nets), _change_norms(nets, snap["weights"])


def lr_at(cell, step):
    """The recipe's learning rate at a step: the epoch's, by the upstream's
    linear policy (constant for n_epochs, then a linear decay over
    n_epochs_decay), epochs numbered from epoch_count."""
    r, tr = cell.config["recipe"], cell.traffic
    if r["lr_policy"] != "linear":
        raise ValueError(f"lr_policy {r['lr_policy']!r}: only the recipe's linear policy is "
                         "worked out by the reference")
    epoch = tr["epoch_count"] + (step - 1) // (tr["examples_per_epoch"] // r["batch_size"])
    return r["lr"] * (1.0 - max(0, epoch + 1 - r["n_epochs"]) / float(r["n_epochs_decay"] + 1))


THRESHOLDED = ("edge", "D_fake_2", "D_real_2", "G_GAN", "G_total")  # read a hard 0.5 threshold


def gaps(got, want):
    """The numbers of one run against the reference, all worked out and
    printed; a cell holds those its limits name. Losses: the worst relative
    gap over steps 1-3 (loss_gap) or step 1 (loss1_gap), of every loss or of
    those no hard threshold feeds (_free). Leaves: the worst leaf's gap of
    first-gradient norms (grad_gap) and of change norms after step 3
    (change_gap), over every leaf or over all but D2's (_free: D2 is fed the
    generator's seg through a hard 0.5 threshold), and the median leaf's
    gaps; leaves whose reference gradient is under a thousandth of the
    median leaf's are left out of the change (they move by round-off
    alone)."""
    (gl, gg, gc_), (wl, wg, wc) = got, want
    rel = lambda a, b: abs(a - b) / max(abs(b), 1e-3)
    per_loss = {k: max(rel(g[k], w[k]) for g, w in zip(gl, wl)) for k in wl[0]}
    first = {k: rel(gl[0][k], wl[0][k]) for k in wl[0]}
    med = float(np.median(list(wg.values())))
    still = {k for k, v in wg.items() if v < 1e-3 * med}
    d2 = {k for k in wc if k.startswith("d2.")}
    leaf = lambda a, b, k: abs(a[k] - b[k]) / max(b[k], 1e-30)
    free = lambda d: [v for k, v in d.items() if k not in THRESHOLDED]
    out = {
        "loss_gap": max(per_loss.values()),
        "loss_free_gap": max(free(per_loss)),
        "loss1_gap": max(first.values()),
        "loss1_free_gap": max(free(first)),
        "grad_gap": check.leaf_gap(gg, wg)[0],
        "grad_free_gap": check.leaf_gap(gg, wg, skip=d2)[0],
        "grad_median": float(np.median([leaf(gg, wg, k) for k in wg])),
        "change_gap": check.leaf_gap(gc_, wc, skip=still)[0],
        "change_free_gap": check.leaf_gap(gc_, wc, skip=still | d2)[0],
        "change_median": float(np.median([leaf(gc_, wc, k) for k in wc if k not in still])),
        "change_d2_median": float(np.median([leaf(gc_, wc, k) for k in d2 - still] or [0.0])),
    }
    print(f"hv_bench: worst loss {max(per_loss, key=per_loss.get)}, gradient "
          f"{check.leaf_gap(gg, wg, skip=d2)[1]} (every leaf: {check.leaf_gap(gg, wg)[1]}), "
          f"change {check.leaf_gap(gc_, wc, skip=still | d2)[1]} (every leaf: "
          f"{check.leaf_gap(gc_, wc, skip=still)[1]}); per loss "
          + " ".join(f"{k} {v:.3g}" for k, v in per_loss.items()), file=sys.stderr)
    return out, sorted(still)


def numbers(cell, rec, got=None, got_window=None, exact=None):
    """Every candidate number of a run: the first steps' (against
    reference_steps) and, prefixed "win_", the step after the window's
    (against reference_window_step). `got`, `got_window`: a variant's
    readings in the system's place; `exact`: the exact references, when
    already worked out."""
    want, want_window = exact or (reference_steps(cell), reference_window_step(cell, rec.snap))
    found, still = gaps(got or rec.host(), want)
    win, win_still = gaps(got_window or rec.host_window(), want_window)
    found.update({f"win_{k}": v for k, v in win.items()})
    return found, still, win_still


def compare(cell, rec):
    found, still, win_still = numbers(cell, rec)
    for what, left in (("the first steps", still), ("the step after the window", win_still)):
        if left:
            print(f"hv_bench: leaves left out of the change of {what} (reference gradient under "
                  f"1e-3 of the median leaf's): {left}", file=sys.stderr)
    print(f"hv_bench: numbers {found}", file=sys.stderr)
    return {k: (found[k], lim) for k, lim in cell.spec["limits"].items()}


def readings(cell, seeds, variants):
    """The compared numbers on each seed for each variant, in one process,
    each seed a whole run (set-up, window, the step after it): None, the
    system as configured; and in the system's place, against the exact
    reference: "tf32", the reference with TF32 (the float32
    configuration's control); "int8", the reference in int8 (the bf16
    configuration's control); "half", the reference with half of each
    batch (a fault)."""
    out = {str(v): {} for v in variants}
    for seed in seeds:
        cell.seed = seed
        rec, _, _ = session(cell, time.perf_counter())
        exact = reference_steps(cell), reference_window_step(cell, rec.snap)
        for v in variants:
            kw = dict(quant="int8" if v == "int8" else None, half=v == "half", tf32=v == "tf32")
            got = None if v is None else reference_steps(cell, **kw)
            got_window = None if v is None else reference_window_step(cell, rec.snap, **kw)
            out[str(v)][seed], _, _ = numbers(cell, rec, got, got_window, exact)
            print(f"hv_bench: readings {v} seed {seed}: {out[str(v)][seed]}", file=sys.stderr)
            gc.collect()
    return out
