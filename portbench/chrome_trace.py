"""Reading a ``torch.profiler`` Chrome trace into what the metrics need.

Device operations are the trace's ``kernel``, ``gpu_memcpy`` and
``gpu_memset`` events. Each kernel is tied to the host call that launched
it by the correlation id of its ``cuda_runtime`` / ``cuda_driver`` event,
and through that call's time and thread to the ``nesr/<stage>`` ranges
(``user_annotation``) that the program's StageTimer opens: a kernel
belongs to a stage when its launch falls inside that stage's range on the
launching thread. Busy time is the union of the device operations'
intervals inside the traced window.
"""

from __future__ import annotations

import bisect
import json
from dataclasses import dataclass, field

__all__ = ["Trace", "load_trace"]

_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
WINDOW = "portbench/window"   # the harness's range around a traced window
REQUEST = "portbench/request"  # and around each request in it


@dataclass
class Op:
    name: str
    cat: str
    ts: float          # microseconds
    dur: float
    stages: tuple = ()


@dataclass
class Trace:
    ops: list = field(default_factory=list)        # device operations
    ranges: dict = field(default_factory=dict)     # name -> [(t0, t1, tid)]
    t0: float = 0.0
    t1: float = 0.0

    def kernels(self, patterns=None, stage: str | None = None) -> list:
        """Kernels whose name holds one of ``patterns`` (all when None),
        launched inside ``stage`` when given."""
        out = []
        for op in self.ops:
            if op.cat != "kernel":
                continue
            if patterns is not None and not any(p in op.name
                                                for p in patterns):
                continue
            if stage is not None and stage not in op.stages:
                continue
            out.append(op)
        return out

    def device_s(self, ops) -> float:
        return sum(op.dur for op in ops) / 1e6

    def busy_s(self) -> float:
        """Seconds in which some device operation ran, inside [t0, t1]."""
        spans = sorted((max(op.ts, self.t0), min(op.ts + op.dur, self.t1))
                       for op in self.ops)
        busy, end = 0.0, float("-inf")
        for a, b in spans:
            if b <= a:
                continue
            if a > end:
                busy += b - a
                end = b
            elif b > end:
                busy += b - end
                end = b
        return busy / 1e6

    def idle_gaps(self, top: int = 10) -> list:
        """The ``top`` longest gaps with no device operation, each named
        by the innermost range open on the host at its middle: a stage
        (``nesr/...``), a request outside its stages (``portbench/request``)
        or none (between requests)."""
        spans = sorted((op.ts, op.ts + op.dur) for op in self.ops)
        gaps, end = [], self.t0
        for a, b in spans:
            if a > end:
                gaps.append((end, a))
            end = max(end, b)
        if self.t1 > end:
            gaps.append((end, self.t1))
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for a, b in gaps[:top]:
            mid = (a + b) / 2
            inner, width = "between requests", float("inf")
            for name, spans_ in self.ranges.items():
                for r0, r1, _ in spans_:
                    if r0 <= mid <= r1 and r1 - r0 < width:
                        inner, width = name, r1 - r0
            out.append([inner, (b - a) / 1e6])
        return out

    def top_ops(self, top: int = 10) -> list:
        by: dict = {}
        for op in self.ops:
            by[op.name] = by.get(op.name, 0.0) + op.dur / 1e6
        return [[k, v] for k, v in sorted(by.items(),
                                          key=lambda kv: -kv[1])[:top]]


def load_trace(path: str, t0_us: float | None = None,
               t1_us: float | None = None) -> Trace:
    """Parse a Chrome trace written by ``export_chrome_trace``. The traced
    window is [t0_us, t1_us] on the trace's clock, by default the span of
    its device operations, or where the trace holds the harness's ranges,
    from the first ``portbench/request``'s start to the last one's end (or
    the ``portbench/window`` range)."""
    with open(path) as f:
        events = json.load(f)
    if isinstance(events, dict):
        events = events.get("traceEvents", [])
    launches: dict = {}
    ranges: dict = {}
    device = []
    for ev in events:
        cat = ev.get("cat")
        if ev.get("ph") != "X":
            continue
        if cat in _DEVICE_CATS:
            device.append(ev)
        elif cat in _LAUNCH_CATS:
            corr = (ev.get("args") or {}).get("correlation")
            if corr is not None:
                launches[corr] = (float(ev["ts"]), ev.get("tid"))
        elif cat == "user_annotation" and (
                str(ev.get("name", "")).startswith("nesr/")
                or ev.get("name") in (WINDOW, REQUEST)):
            ranges.setdefault(ev["name"], []).append(
                (float(ev["ts"]), float(ev["ts"]) + float(ev.get("dur", 0)),
                 ev.get("tid")))
    starts = {name: sorted(spans) for name, spans in ranges.items()}
    keys = {name: [s[0] for s in spans] for name, spans in starts.items()}
    window = starts.pop(WINDOW, None)
    keys.pop(WINDOW, None)
    requests = starts.get(REQUEST)
    if requests and t0_us is None:
        t0_us, t1_us = requests[0][0], max(r[1] for r in requests)
    elif window and t0_us is None:
        t0_us, t1_us = window[0][0], window[0][1]
    tr = Trace(ranges=starts)
    for ev in device:
        stages = ()
        corr = (ev.get("args") or {}).get("correlation")
        if corr in launches:
            lts, tid = launches[corr]
            found = []
            for name, spans in starts.items():
                # a stage's ranges follow one another on the host thread
                i = bisect.bisect_right(keys[name], lts) - 1
                if i >= 0:
                    r0, r1, rtid = spans[i]
                    if r0 <= lts <= r1 and rtid == tid:
                        found.append(name)
            stages = tuple(found)
        tr.ops.append(Op(str(ev.get("name", "")), ev["cat"], float(ev["ts"]),
                         float(ev.get("dur", 0.0)), stages))
    if tr.ops:
        first = min(op.ts for op in tr.ops)
        last = max(op.ts + op.dur for op in tr.ops)
    else:
        first = last = 0.0
    tr.t0 = first if t0_us is None else t0_us
    tr.t1 = last if t1_us is None else t1_us
    return tr
