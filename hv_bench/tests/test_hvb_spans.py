"""The program's span recorder against the benchmark's trace reduction,
and the recorder's cost probe (hv_bench/span_cost.py) at tiny sizes on the
CPU. No cell turns the recorder on: these show that its records, given to
`trace.reduce` as span events, name the idle gaps they hold, and that the
probe runs."""

import pytest

from hv_bench import span_cost, trace
from healthivert_tpu_torch.utils import spans


@pytest.fixture(autouse=True)
def recorder_off():
    spans.disable()
    spans.drain()
    yield
    spans.disable()
    spans.drain()


def test_reduce_names_a_gap_by_the_innermost_program_span(monkeypatch):
    clock = iter([1_000, 3_000, 6_000, 8_000, 8_500, 9_500])
    monkeypatch.setattr(spans.time, "time_ns", lambda: next(clock))
    spans.enable()
    with spans.span("hv.3d.geometry", rid=1):  # 1000-8000
        with spans.span("hv.3d.readback", rid=1):  # 3000-6000
            pass
    with spans.span("hv.3d.assemble", rid=1):  # 8500-9500
        pass
    records = spans.drain()
    E = trace.Event
    events = [E("span", trace.MEASURED, 0, 10_000, -1), E("span", "hv.patient", 0, 10_000, -1),
              E("launch", "cudaLaunchKernel", 100, 110, 1),
              E("launch", "cudaLaunchKernel", 200, 210, 2),
              E("device", "k1", 500, 2_000, 1), E("device", "k2", 7_000, 7_600, 2)]
    events += [E("span", r.name, r.start, r.end, -1) for r in records]
    win = trace.reduce(events)
    # idle: 0-500 (outside the program's spans), 2000-7000 (mid 4500: readback
    # inside geometry), 7600-10000 (mid 8800: assemble)
    assert win.gaps == [("hv.3d.readback", 5e-6), ("hv.3d.assemble", 2.4e-6),
                        ("hv.patient", 5e-7)]


def test_the_cost_probe_at_tiny_sizes(tiny_root, capsys):
    out = span_cost.main(["--seed", str(2 ** 33 + 5), "--reps", "1", "--blocks", "1",
                          "--calls", "2000"], device="cpu", root=tiny_root)
    assert out["span_ns_on"] > out["span_ns_off"] >= -out["loop_ns"]
    assert len(out["synth_traced_patient_s"]["on"]) == 1 == len(out["train_block8_s"]["off"])
    assert {"hv.3d.geometry", "hv.3d.readback", "hv.3d.reassemble"} <= set(
        out["synth_split_pct"])
    assert 0 < sum(out["synth_split_pct"].values()) <= 100.0 + 1e-6
    assert {"hv.train.data", "hv.train.step"} <= set(out["train_split_pct"])
    assert 0 < sum(out["train_split_pct"].values()) <= 100.0 + 1e-6
    assert not spans.enabled() and spans.drain() == []
