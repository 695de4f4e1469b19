"""The trace reduction on a small saved Chrome trace: kernel times of the
measured range only, busy time as the union of device intervals, idle gaps
named by the host span around them, lost records; and on device records
with the benchmark's own host spans."""

import json

import pytest

from hv_bench import trace


def _trace(tmp_path, lose=False):
    ev = []
    x = lambda cat, name, ts, dur, corr=None: ev.append(
        {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "args": {} if corr is None else {"correlation": corr}})
    x("kernel", "early_kernel", 5, 3, 1)  # launched before the range
    x("cuda_runtime", "cudaLaunchKernel", 2, 1, 1)
    x("user_annotation", trace.MEASURED, 10, 100)
    x("user_annotation", "hv.step", 10, 35)
    x("user_annotation", "hv.eval", 50, 60)
    for corr, (ts, dur, name) in enumerate([(12, 10, "lp_gemm<0>"), (20, 10, "conv_x"),
                                            (70, 20, "lp_gemm<0>")], start=2):
        x("cuda_runtime", "cudaLaunchKernel", ts - 1, 1, corr)
        if not (lose and corr == 4):
            x("kernel", name, ts, dur, corr)
    x("gpu_memcpy", "Memcpy HtoD", 95, 5, 9)
    x("cuda_runtime", "cudaMemcpyAsync", 94, 1, 9)
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    return path


def test_reduce_saved_trace(tmp_path):
    w = trace.reduce(trace.from_chrome(_trace(tmp_path)))
    assert w.lost == 0
    assert set(w.kernels) == {"lp_gemm<0>", "conv_x", "Memcpy HtoD"}
    assert w.kernels["lp_gemm<0>"] == pytest.approx(30e-6)
    # busy: [12, 30) + [70, 90) + [95, 100) = 43 us of the 100 us range
    assert w.busy_s == pytest.approx(43e-6)
    assert w.window_s == pytest.approx(100e-6)
    # idle: [10, 12), [30, 70), [90, 95), [100, 110)
    assert w.gaps[0] == ("hv.eval", pytest.approx(40e-6))
    assert [g[1] for g in w.gaps] == pytest.approx([40e-6, 10e-6, 5e-6, 2e-6])
    assert w.gaps[-1][0] == "hv.step"


def test_reduce_counts_lost_records(tmp_path):
    assert trace.reduce(trace.from_chrome(_trace(tmp_path, lose=True))).lost == 1



def test_own_spans_bound_the_range_and_name_the_gaps():
    spans = trace.Spans()
    with spans(trace.MEASURED):
        with spans("hv.step"):
            t = spans._open["hv.step"]
    m = spans.events[-1]
    assert m.name == trace.MEASURED and m.start <= t <= m.end
    # a device-only trace on the spans' clock: one launch inside the range
    ev = spans.events + [trace.Event("launch", "cudaLaunchKernel", t, t + 1, 7),
                         trace.Event("device", "k", t + 2, t + 3, 7)]
    w = trace.reduce(ev)
    assert w.kernels == {"k": pytest.approx(1e-9)} and w.lost == 0
    assert w.gaps[0][0] in ("hv.step", trace.MEASURED, "outside any span")


def test_spans_on_another_clock_are_refused():
    spans = trace.Spans()
    with spans(trace.MEASURED):
        pass
    far = spans.events[0].end + 10 ** 12
    ev = spans.events + [trace.Event("launch", "cudaLaunchKernel", far, far + 1, 3),
                         trace.Event("device", "k", far + 2, far + 3, 3)]
    with pytest.raises(RuntimeError, match="clock"):
        trace.reduce(ev)
