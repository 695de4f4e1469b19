"""One rank of a multi-process test of the port, and the launcher of its
ranks (`Ranks`): torch.distributed with a rendezvous through a file store
(so that test processes running side by side never share a port), gloo
unless the job names another backend, one torch thread, exact float32.

Not a test file, and free of JAX, so that the card-only tests use it too.
`Ranks` starts the ranks as
    python torch_dist_worker.py <job.pt> <out_dir>
with RANK, WORLD_SIZE and LOCAL_RANK in the environment, as torchrun sets
them. job.pt holds {"store": path, "device": "cpu" or "cuda:0", "backend":
None or a name, "tasks": [(name, kind, args), ...]}; the rank runs the
tasks in order and writes {name: result, "world": N} to
<out_dir>/rank<RANK>.pt. Kinds:

- bn:        NLayerDiscriminator forward of this rank's half of x with the
             global BatchNorm statistics, and the gradient of sum(out * w)
- step:      one train_step on this rank's slice of a global batch (with
             args["mesh"], on that mesh: the slice of the rank's data
             coordinate)
- aligned:   one epoch of AlignedDataset batches (training split)
- train:     run_training(opt) for max_steps: each step's losses, attention
             launches and end time (host clock after a synchronise), the
             first step's gradients (from one state on every run), the
             networks and their last gradients
- train_cli: the train CLI's main(argv); the generator's state dict after
"""

import datetime
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from healthivert_tpu_torch.parallel import distributed  # noqa: E402

NETS = ("g", "d1", "d2", "d3")


class Ranks:
    """`world` ranks running `tasks` under one process group (a file store in
    `out_dir`) on `device`, started at once so that the caller can work
    meanwhile; results() waits for them (at most `timeout` seconds, then
    kills them all and raises) and returns each rank's {name: result}. A
    rank that exits non-zero raises with its output."""

    def __init__(self, out_dir, tasks, world=2, device="cpu", backend=None, timeout=240):
        self.out, self.world, self.timeout = str(out_dir), world, timeout
        job = os.path.join(self.out, "job.pt")
        torch.save({"store": os.path.join(self.out, "store"), "device": device,
                    "backend": backend, "tasks": tasks}, job)
        env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH", "XLA_FLAGS")}
        env.update(WORLD_SIZE=str(world), OMP_NUM_THREADS="1")
        self.procs = [
            subprocess.Popen([sys.executable, os.path.abspath(__file__), job, self.out],
                             env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
            for r in range(world)]

    def results(self):
        logs = []
        try:
            for p in self.procs:
                logs.append(p.communicate(timeout=self.timeout)[0].decode(errors="replace"))
        except subprocess.TimeoutExpired:
            for p in self.procs:
                p.kill()
                p.communicate()
            raise RuntimeError(f"a rank ran past {self.timeout} s")
        for r, (p, log) in enumerate(zip(self.procs, logs)):
            if p.returncode != 0:
                raise RuntimeError(f"rank {r} exited {p.returncode}:\n{log[-4000:]}")
        return [torch.load(os.path.join(self.out, f"rank{r}.pt"), weights_only=False)
                for r in range(self.world)]


def _slice(batch, device):
    n = next(iter(batch.values())).shape[0]
    part = distributed.process_batch_slice(n)
    return {k: torch.from_numpy(np.ascontiguousarray(v[part])).to(device)
            for k, v in batch.items()}


def _nets(state):
    return dict(zip(NETS, (state.gen, state.d1, state.d2, state.d3)))


def grads(state):
    """Host copies of the networks' parameter gradients."""
    return {n: {k: p.grad.detach().cpu().clone() for k, p in m.named_parameters()}
            for n, m in _nets(state).items()}


def _snapshot(state):
    """Host copies of the networks' state dicts and parameter gradients."""
    return {
        "after": {n: {k: v.detach().cpu().clone() for k, v in m.state_dict().items()}
                  for n, m in _nets(state).items()},
        "grads": grads(state),
    }


def run_training_first_grads(opt, **kwargs):
    """run_training(opt, **kwargs) -> (state, cfg, the first step's
    gradients): the step is wrapped while the run lasts."""
    from healthivert_tpu_torch.engine import train_loop

    step_fn, first = train_loop.train_step, {}

    def recording(state, batch, lr, cfg):
        out = step_fn(state, batch, lr, cfg)
        if not first:
            first.update(grads(state))
        return out

    train_loop.train_step = recording
    try:
        state, cfg = train_loop.run_training(opt, **kwargs)
    finally:
        train_loop.train_step = step_fn
    return state, cfg, first


def bn(args, device):
    from healthivert_tpu_torch.models.discriminator import NLayerDiscriminator

    d = NLayerDiscriminator(1, args["ndf"], 3, "batch").to(device)
    d.load_state_dict(args["sd"])
    xs = _slice({"x": args["x"], "w": args["w"]}, device)
    x = xs["x"].requires_grad_(True)
    out = d(x)
    (out * xs["w"]).sum().backward()
    stats = {k: v.cpu().clone() for k, v in d.state_dict().items() if ".running_" in k}
    return {"out": out.detach().cpu(), "grad": x.grad.cpu(), "stats": stats}


def step(args, device):
    from healthivert_tpu_torch.models import pix2pix

    if "mesh" in args:
        from healthivert_tpu_torch.parallel.mesh import make_mesh

        make_mesh(args["mesh"], devices=[device])
    cfg = pix2pix.Pix2PixConfig(**args["cfg"])
    state = pix2pix.init_state(cfg, seed=0, device=device)
    for name, m in _nets(state).items():
        m.load_state_dict(args["sds"][name])
    state, losses = pix2pix.train_step(state, _slice(args["batch"], device), args["lr"], cfg)
    return dict(_snapshot(state), losses={k: float(v) for k, v in losses.items()})


def aligned(args, device):
    import types

    from healthivert_tpu_torch.data.aligned import AlignedDataset

    ds = AlignedDataset(types.SimpleNamespace(**args))
    return [{k: np.asarray(v) for k, v in b.items()} for b in ds]


def train(args, device):
    import types

    from healthivert_tpu_torch.ops.attention_cuda import attention_v2, attention_v2_bwd

    counter = "tf32_launches" if device.startswith("cuda") else "launches"
    steps = []

    def on_step(step_no, losses):
        if device.startswith("cuda"):
            torch.cuda.synchronize()
        steps.append({"losses": {k: float(v) for k, v in losses.items()},
                      "launches": (getattr(attention_v2, counter),
                                   getattr(attention_v2_bwd, counter)),
                      "t": time.perf_counter()})

    state, _, first = run_training_first_grads(types.SimpleNamespace(**args["opt"]),
                                               max_steps=args["max_steps"], device=device,
                                               on_step=on_step)
    return dict(_snapshot(state), steps=steps, first_grads=first)


def train_cli(args, device):
    from healthivert_tpu_torch.cli import train as cli

    state, _ = cli.main(args["argv"])
    return {"gen": {k: v.clone() for k, v in state.gen.state_dict().items()},
            "step": state.step}


def main():
    from healthivert_tpu_torch.utils.device import float32_exact

    job = torch.load(sys.argv[1], weights_only=False)
    out_dir = sys.argv[2]
    torch.set_num_threads(1)
    float32_exact()
    device = job["device"]
    distributed.ensure_initialized(device=device, backend=job["backend"],
                                   init_method="file://" + job["store"],
                                   timeout=datetime.timedelta(seconds=120))
    kinds = {"bn": bn, "step": step, "aligned": aligned, "train": train, "train_cli": train_cli}
    results = {name: kinds[kind](args, device) for name, kind, args in job["tasks"]}
    results["world"] = distributed.process_count()
    torch.save(results, os.path.join(out_dir, f"rank{distributed.process_index()}.pt"))
    distributed.shutdown()


if __name__ == "__main__":
    main()
