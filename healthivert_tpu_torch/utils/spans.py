"""Program spans: a process-wide recorder of named host intervals, for
profiled windows: the train CLI's `--profile_steps` turns it on with its
profiler, and `python3 -m hv_bench.span_cost` measures it on the card.

A record holds the span's name, its start and end on `time.time_ns` (the
clock of torch.profiler's host records, so that a span lines up with the
kernel launches of a trace), the index of the span open around it in the
drained list (-1: none), a request id (the 3D driver's patient call, the
training loop's step; a span given none takes its parent's) and the
attributes it was opened with. Records stay in memory until `drain()`;
`self_times` splits a range of them by span name.

Off is the default. Off, `span()` returns one shared no-op context and
`record()` returns at once: a call site costs a flag check. On or off, the
recorder reads no tensor, allocates none and synchronises no device; a span
times the host, and where the host waits on the card (a `.cpu()`), the wait.
Spans are opened from one thread, the caller's of the instrumented loop.
"""

from __future__ import annotations

import contextlib
import time
from typing import NamedTuple, Optional


class Span(NamedTuple):
    name: str
    start: int  # ns, time.time_ns
    end: Optional[int]  # None: still open when drained
    parent: int  # index of the enclosing span in the drained list, -1 for none
    rid: Optional[int]  # request id
    attrs: dict


_NOOP = contextlib.nullcontext()
_on = False
_records: list = []  # [name, start, end, parent, rid, attrs], in order of opening
_open: list = []  # indices into _records of the spans open now, innermost last


def enable():
    global _on
    _on = True


def disable():
    global _on
    _on = False


def enabled() -> bool:
    return _on


def drain() -> list:
    """The records so far as Spans, oldest first, and an empty recorder. A
    span still open is returned with end None and its close is not kept."""
    out = [Span(*r) for r in _records]
    _records.clear()
    _open.clear()
    return out


def _parent(rid):
    if not _open:
        return -1, rid
    i = _open[-1]
    return i, _records[i][4] if rid is None else rid


class _Open:
    __slots__ = ("rec", "idx")

    def __init__(self, name, rid, attrs):
        self.rec, self.idx = [name, 0, None, -1, rid, attrs], -1

    def __enter__(self):
        self.rec[3], self.rec[4] = _parent(self.rec[4])
        self.idx = len(_records)
        _records.append(self.rec)
        _open.append(self.idx)
        self.rec[1] = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        # a drain() while the span was open has handed its record out already
        if self.idx < len(_records) and _records[self.idx] is self.rec:
            self.rec[2] = end
            _open.remove(self.idx)
        return False


def span(name: str, rid: Optional[int] = None, **attrs):
    """A context that records `name` around its body while the recorder is
    on; off, the shared no-op context."""
    if not _on:
        return _NOOP
    return _Open(name, rid, attrs)


def record(name: str, start: int, end: int, rid: Optional[int] = None, **attrs):
    """Record an interval the caller has already timed on time.time_ns
    (nothing while the recorder is off)."""
    if not _on:
        return
    parent, rid = _parent(rid)
    _records.append([name, start, end, parent, rid, attrs])


def _union(intervals) -> int:
    total, edge = 0, None
    for s, t in sorted(intervals):
        if edge is None or s > edge:
            total, edge = total + t - s, t
        elif t > edge:
            total, edge = total + t - edge, t
    return total


def self_times(records, lo: int, hi: int) -> dict:
    """{span name: self seconds inside [lo, hi] (time.time_ns)} of drained
    records: a span's self time is the part of its interval in the range
    that none of its children (the records whose parent it is) covers; a
    name's is the sum over its spans. Open spans are left out."""
    kids = {}
    for r in records:
        if r.end is not None and r.parent >= 0:
            kids.setdefault(r.parent, []).append(r)
    out = {}
    for i, r in enumerate(records):
        s, t = max(r.start, lo), min(r.end if r.end is not None else lo, hi)
        if t <= s:
            continue
        inner = [(max(c.start, s), min(c.end, t)) for c in kids.get(i, ())]
        own = (t - s) - _union([(a, b) for a, b in inner if b > a])
        out[r.name] = out.get(r.name, 0.0) + own / 1e9
    return out
