"""The traced sub-window: torch.profiler over a short steady stretch of the
run, reduced to the device's busy time, each kernel's time, and the longest
idle gaps named by the benchmark's own host spans.

The window method is chip_smoke.py's (`profile_ms`, `measured_kernels`):
the profiler's records on the card's machine can lack kernels that a
window ran first, though their launches are recorded, the more the older
the process. So a window first runs its work unmeasured for WARM_S, counts
only the device operations launched inside its MEASURED range (matched to
their launches by correlation id), and is taken again, up to TRIES times,
until every launch in that range has its record.

The profiler records device activity only (CUDA: kernels, copies, fills
and their launches). Recording every host operation as well slowed the
host by 15-50 % and so inflated the idle share of host-bound cells. The
benchmark's host spans, the MEASURED range among them, are therefore its
own (`Spans`), timed on time.time_ns, the clock of the profiler's host
records (its launch timestamps); a range that holds device records but
no launch means the clocks disagree, and the reduction refuses it.

Events are reduced from one neutral form, (kind, name, start_ns, end_ns,
correlation), read from the profiler's own results or from a saved Chrome
trace, so that the reduction is tested on a trace file.
"""

from __future__ import annotations

import contextlib
import json
import time
from typing import List, NamedTuple

WARM_S = 0.1
TRIES = 5
MEASURED = "hv_bench.measured"
SPAN = "hv."  # prefix of the benchmark's host spans (Spans names)


class Event(NamedTuple):
    kind: str  # "device" (kernel, copy, fill), "launch", "span" (a host range), "host"
    name: str
    start: int  # ns
    end: int
    corr: int


def activities(device):
    """What the profiler records: the card's activity (the host's
    operations on the CPU, which has no card)."""
    from torch.profiler import ProfilerActivity

    return [ProfilerActivity.CPU if device == "cpu" else ProfilerActivity.CUDA]


class Spans:
    """The benchmark's own host spans, as Events on the profiler's clock."""

    def __init__(self):
        self.events, self._open = [], {}

    def start(self, name):
        self._open[name] = time.time_ns()

    def end(self, name):
        self.events.append(Event("span", name, self._open.pop(name), time.time_ns(), -1))

    @contextlib.contextmanager
    def __call__(self, name):
        self.start(name)
        try:
            yield
        finally:
            self.end(name)


def from_profiler(prof) -> List[Event]:
    """Events of a finished torch.profiler.profile."""
    import torch

    cuda, out = torch.autograd.DeviceType.CUDA, []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == cuda:
            if not e.is_user_annotation():
                out.append(Event("device", e.name(), e.start_ns(), e.end_ns(), e.correlation_id()))
            continue
        kind = "span" if e.is_user_annotation() else (
            "launch" if e.name().startswith("cu") else "host")
        out.append(Event(kind, e.name(), e.start_ns(), e.end_ns(), e.correlation_id()))
    return out


def from_chrome(path) -> List[Event]:
    """Events of a Chrome trace written by torch.profiler."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kinds = {"kernel": "device", "gpu_memcpy": "device", "gpu_memset": "device",
             "cuda_runtime": "launch", "cuda_driver": "launch", "user_annotation": "span",
             "gpu_user_annotation": None}
    out = []
    for e in events:
        if e.get("ph") != "X":
            continue
        kind = kinds.get(e.get("cat"), "host")
        if kind is None:
            continue
        start = int(round(float(e["ts"]) * 1000))
        end = start + int(round(float(e.get("dur", 0)) * 1000))
        corr = int(e.get("args", {}).get("correlation", -1))
        out.append(Event(kind, e["name"], start, end, corr))
    return out


class Window(NamedTuple):
    kernels: dict  # device seconds by name, of the operations launched inside MEASURED
    busy_s: float  # union of those operations' intervals
    window_s: float  # the MEASURED range's length on the host clock
    gaps: list  # [(host span, seconds)] of the longest idle stretches, longest first
    lost: int  # launches inside MEASURED without a device record


def reduce(events: List[Event], top_gaps: int = 10) -> Window:
    """The MEASURED range's device work and idle stretches."""
    span = next(e for e in events if e.kind == "span" and e.name == MEASURED)
    inside = {e.corr for e in events if e.kind == "launch"
              and span.start <= e.start <= span.end}
    if not inside and any(e.kind == "device" for e in events):
        raise RuntimeError("no launch inside the measured span, though the card ran: the "
                           "spans' clock is not the profiler's")
    launches = {e.corr for e in events if e.kind == "launch" and "Launch" in e.name
                and span.start <= e.start <= span.end}
    ops = sorted((e for e in events if e.kind == "device" and e.corr in inside),
                 key=lambda e: e.start)
    kernels = {}
    for e in ops:
        kernels[e.name] = kernels.get(e.name, 0.0) + (e.end - e.start) / 1e9
    recorded = {e.corr for e in ops}
    lost = len(launches - recorded)
    # busy: union of the intervals; idle: the stretches of the range between them
    busy, cur, idle = 0, None, []
    lo, hi = span.start, max([span.end] + [e.end for e in ops])
    edge = lo
    for e in ops:
        s, t = max(e.start, lo), min(e.end, hi)
        if cur is None or s > cur[1]:
            if cur is not None:
                busy += cur[1] - cur[0]
            if s > edge:
                idle.append((edge, s))
            cur = [s, t]
        else:
            cur[1] = max(cur[1], t)
        edge = max(edge, cur[1])
    if cur is not None:
        busy += cur[1] - cur[0]
    if hi > edge:
        idle.append((edge, hi))
    spans = [e for e in events if e.kind == "span" and e.name.startswith(SPAN)
             and e.name != MEASURED]
    gaps = []
    for s, t in sorted(idle, key=lambda g: g[0] - g[1])[:top_gaps]:
        mid = (s + t) // 2
        around = [e for e in spans if e.start <= mid <= e.end]
        name = min(around, key=lambda e: e.end - e.start).name if around else "outside any span"
        gaps.append((name, (t - s) / 1e9))
    return Window(kernels, busy / 1e9, (hi - lo) / 1e9, gaps, lost)

