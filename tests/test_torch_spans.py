"""The port's program spans (healthivert_tpu_torch/utils/spans.py) on the
CPU: the recorder's contract (off: the shared no-op, nothing read,
allocated or recorded; on: parent indices, request ids, time.time_ns,
drain, self times), the span names of the 3D driver and of the training loop, the
--profile_steps window's spans.json, and bitwise-equal results with the
recorder on and off: run_training's parameters, buffers, Adam moments and
on_step sequence (the tiny size of tests/test_torch_train_loop.py), and
synthesize_volumes' volumes (the size of tests/test_torch_infer3d.py)."""

import json
import time
import tracemalloc
import types

import numpy as np
import pytest
import torch

from healthivert_tpu_torch.data.synthetic import make_spine_volume
from healthivert_tpu_torch.engine import infer3d, train_loop
from healthivert_tpu_torch.models.generator import Generator
from healthivert_tpu_torch.models.pix2pix import Pix2PixConfig
from healthivert_tpu_torch.utils import spans
from healthivert_tpu_torch.utils.weights import flax_to_state_dict
from torch_port_fixtures import one_torch_thread  # noqa: F401 (fixture)
from torch_port_fixtures import random_generator_vars

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SYNTH_SPANS = {"hv.3d.prep", "hv.3d.geometry", "hv.3d.dispatch", "hv.3d.readback",
               "hv.3d.reassemble", "hv.3d.assemble"}
TRAIN_SPANS = {"hv.train.data", "hv.train.step", "hv.train.log", "hv.train.save",
               "hv.train.eval"}


@pytest.fixture(autouse=True)
def recorder_off():
    spans.disable()
    spans.drain()
    yield
    spans.disable()
    spans.drain()


def _no_device_or_tensor(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the recorder touched a tensor or the device")

    for name in ("synchronize", "current_stream", "Event"):
        monkeypatch.setattr(torch.cuda, name, refuse)
    for name in ("tensor", "empty", "zeros", "as_tensor", "from_numpy"):
        monkeypatch.setattr(torch, name, refuse)


def test_off_is_the_shared_noop_and_reads_no_clock(monkeypatch):
    _no_device_or_tensor(monkeypatch)

    def no_clock():
        raise AssertionError("the recorder read the clock while off")

    monkeypatch.setattr(spans.time, "time_ns", no_clock)
    first = spans.span("hv.3d.prep", rid=1)
    assert first is spans.span("hv.train.step", rid=2, **{"pass": "upper"}) is spans._NOOP
    with first:
        with spans.span("hv.inner"):
            spans.record("hv.train.data", 1, 2, rid=3)
    assert not spans.enabled() and spans.drain() == []


def test_off_keeps_no_memory():
    def calls(n):
        for i in range(n):
            with spans.span("hv.3d.dispatch", rid=i, **{"pass": "lower"}):
                spans.record("hv.train.data", i, i + 1, rid=i)

    calls(10)  # warm the interpreter's caches
    tracemalloc.start()
    try:
        before = tracemalloc.get_traced_memory()[0]
        calls(10_000)
        after, peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    assert after - before < 512 and peak - before < 4096, (before, after, peak)


def test_on_nests_with_parent_indices_request_ids_and_time_ns(monkeypatch):
    _no_device_or_tensor(monkeypatch)
    clock = iter(range(100, 200))
    monkeypatch.setattr(spans.time, "time_ns", lambda: next(clock))
    spans.enable()
    with spans.span("a", rid=7):
        with spans.span("b", k=1):
            spans.record("c", 101, 102)
        with spans.span("d", rid=9):
            pass
    spans.record("e", 5, 6)
    got = spans.drain()
    assert [r.name for r in got] == ["a", "b", "c", "d", "e"]
    assert [r.parent for r in got] == [-1, 0, 1, 0, -1]
    assert [r.rid for r in got] == [7, 7, 7, 9, None]
    assert got[1].attrs == {"k": 1} and got[0].attrs == {}
    assert [(r.start, r.end) for r in got] == [(100, 105), (101, 102), (101, 102),
                                               (103, 104), (5, 6)]
    assert spans.drain() == []


def test_the_clock_is_time_ns():
    spans.enable()
    lo = time.time_ns()
    with spans.span("a"):
        pass
    hi = time.time_ns()
    (r,) = spans.drain()
    assert lo <= r.start <= r.end <= hi


def test_a_span_open_at_drain_is_handed_out_open():
    spans.enable()
    with spans.span("outer", rid=1):
        (r,) = spans.drain()
        with spans.span("inner"):
            pass
    assert r.name == "outer" and r.end is None
    (inner,) = spans.drain()
    assert inner.name == "inner" and inner.parent == -1 and inner.end is not None



def test_self_times_split_a_range():
    mk = lambda name, start, end, parent: spans.Span(name, start, end, parent, 1, {})
    records = [mk("a", 0, 100, -1), mk("b", 10, 30, 0), mk("c", 20, 50, 0),
               mk("d", 25, 26, 2), mk("e", 90, 130, -1), mk("open", 5, None, -1)]
    # a: 100 less its children's union [10, 50]; c: 30 less d's 1; e: clipped to 120
    assert spans.self_times(records, 0, 120) == pytest.approx(
        {"a": 60e-9, "b": 20e-9, "c": 29e-9, "d": 1e-9, "e": 30e-9})
    # clipping takes each child's part inside the parent's clipped interval
    assert spans.self_times(records, 40, 60) == pytest.approx(
        {"a": 10e-9, "c": 10e-9})


# ----------------------------------------------------------- the 3D driver

def _spine(seed=0):
    return make_spine_volume(
        np.random.default_rng(seed), shape=(64, 64, 16), vert_ids=(19, 20, 21),
        vert_height=12, gap=5, fractured={20: 0.6},
    )


def _synthesize(gen, on):
    (spans.enable if on else spans.disable)()
    ct, labels, cam = _spine()
    vols = [(ct, labels, v, cam) for v in (19, 20, 21)]
    try:
        return infer3d.synthesize_volumes(gen, Pix2PixConfig(ngf=4, image_size=64), vols,
                                          batch_size=8, use_bf16=False, device="cpu")
    finally:
        spans.disable()


def test_synthesis_equal_with_the_recorder_on_and_named():
    v = random_generator_vars(4)
    gen = Generator(cnum=4)
    gen.load_state_dict(flax_to_state_dict(v["params"], v["sn"]))
    gen.eval()
    off = _synthesize(gen, False)
    assert spans.drain() == []
    on = _synthesize(gen, True)
    for (a_ct, a_lb), (b_ct, b_lb) in zip(off, on):
        assert np.array_equal(a_ct, b_ct) and np.array_equal(a_lb, b_lb)
    got = spans.drain()
    assert {r.name for r in got} == SYNTH_SPANS
    assert {r.rid for r in got} == {infer3d.synthesize_volumes.calls}
    assert all(r.end >= r.start and r.parent == -1 for r in got)
    for name in ("hv.3d.geometry", "hv.3d.reassemble"):
        assert [r.attrs["pass"] for r in got if r.name == name] == ["upper", "lower", "target"]
    dispatches = [r for r in got if r.name == "hv.3d.dispatch"]
    assert len(dispatches) == len([r for r in got if r.name == "hv.3d.readback"]) >= 3
    assert [r.name for r in got][0] == "hv.3d.prep" and [r.name for r in got][-1] == \
        "hv.3d.assemble"


# ------------------------------------------------------- the training loop

def _opt(tmp_path, **kw):
    base = dict(
        dataset_mode="synthetic", batch_size=2, seed=3, crop_size=64, ndf=8, lr=2e-4,
        beta1=0.5, gan_mode="vanilla", epoch_count=1, n_epochs=5, n_epochs_decay=5,
        lr_policy="linear", print_freq=2, compute_dtype="float32", name="run",
        checkpoints_dir=str(tmp_path), save_latest_freq=6, save_epoch_freq=1,
        save_by_iter=False, display_freq=0, epoch="latest", load_iter=0, eval_freq=1,
    )
    base.update(kw)
    return types.SimpleNamespace(**base)


@pytest.fixture
def two_step_epochs(monkeypatch):
    """Epochs of two steps and an eval split of two batches, so that a few
    steps reach the epoch's save and eval."""
    create = train_loop.create_dataset

    def small(opt):
        ds = create(opt)
        ds.size = 2 * opt.batch_size
        return ds

    monkeypatch.setattr(train_loop, "create_dataset", small)


def _train(tmp_path, on):
    seen = []
    (spans.enable if on else spans.disable)()
    opt_test = _opt(tmp_path, batch_size=3)
    opt_test.synthetic_cache = 0
    try:
        state, _ = train_loop.run_training(
            _opt(tmp_path / ("on" if on else "off")), opt_test, max_steps=5, device="cpu",
            on_step=lambda step, losses: seen.append(
                (step, {k: v.detach().clone() for k, v in losses.items()})))
    finally:
        spans.disable()
    return state, seen


def _leaves(state):
    out = {}
    for name in ("gen", "d1", "d2", "d3"):
        out.update({f"{name}.{k}": v for k, v in getattr(state, name).state_dict().items()})
    for name in ("opt_g", "opt_d1", "opt_d2", "opt_d3"):
        for i, st in getattr(state, name).state_dict()["state"].items():
            out.update({f"{name}.{i}.{k}": v for k, v in st.items()})
    return out


def test_training_equal_with_the_recorder_on_and_named(tmp_path, two_step_epochs):
    s_off, seen_off = _train(tmp_path, False)
    assert spans.drain() == []
    s_on, seen_on = _train(tmp_path, True)
    assert s_off.step == s_on.step == 5
    a, b = _leaves(s_off), _leaves(s_on)
    assert set(a) == set(b) and any(k.endswith("exp_avg_sq") for k in a)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert [s for s, _ in seen_off] == [s for s, _ in seen_on] == [1, 2, 3, 4, 5]
    for (_, la), (_, lb) in zip(seen_off, seen_on):
        assert la.keys() == lb.keys() and all(torch.equal(la[k], lb[k]) for k in la)
    got = spans.drain()
    assert {r.name for r in got} == TRAIN_SPANS
    steps = [r for r in got if r.name == "hv.train.step"]
    assert [r.rid for r in steps] == [1, 2, 3, 4, 5]
    assert [r.rid for r in got if r.name == "hv.train.data"] == [1, 2, 3, 4, 5]
    assert all(r.parent == -1 and r.end >= r.start for r in got)
    # a step's data wait ends where its step starts (the loop's clock points)
    data = [r for r in got if r.name == "hv.train.data"]
    assert all(d.end <= s.start for d, s in zip(data, steps))


def test_profile_window_writes_its_spans(tmp_path, capsys):
    train_loop.run_training(_opt(tmp_path, save_epoch_freq=5, save_latest_freq=5000,
                                 eval_freq=15), max_steps=4, profile_steps=(1, 3),
                            device="cpu")
    assert "written to" in capsys.readouterr().out
    out = tmp_path / "run" / "profile"
    assert (out / "trace.json").exists()
    got = json.loads((out / "spans.json").read_text())
    assert {r["name"] for r in got} >= {"hv.train.data", "hv.train.step"}
    assert [r["rid"] for r in got if r["name"] == "hv.train.step"] == [2, 3]
    assert set(got[0]) == {"name", "start", "end", "parent", "rid", "attrs"}
    assert not spans.enabled() and spans.drain() == []
