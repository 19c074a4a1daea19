"""The port's tracer: stages, spans and counters.

Counterpart of ``neural_enhanced_super_resolution_tpu/runtime/profiler.py``.
Each stage and span is a ``torch.profiler.record_function`` range
``nesr/<name>`` while a ``torch.profiler`` records, and accumulates
host wall clock in ``totals[name]`` (seconds; ``counts[name]`` calls).

* A **stage** synchronises CUDA first, at both ends, so its host total is
  its wall time with its device work: the current GPU, or each CUDA device
  of ``devices`` (the devices a multi-device layout uses, and no other: a
  synchronize on a GPU the process does not use would create a CUDA
  context there). A stage opened with ``sync_start`` or ``sync_end`` false
  leaves that end unsynchronised (under stage overlap the ESRGAN branch's
  stage times its dispatch only, and its work is waited for later). The
  time spent in those waits is ``totals["sync"]``, and ``counts["sync"]``
  the number of device synchronizations.
* A **span** never synchronises. Inside a request on a CUDA home device it
  also records a pair of timing events on the device's current stream
  (from a pool), and so does a stage; the events are read in one batch
  when the request ends, after its last wait, into ``totals["device/<name>"]``
  (the span on the device's timeline, seconds). Spans on another device
  (a multi-device layout's other slots), and stages whose ``devices``
  hold another device than the home one, read the host clock only. A span
  opened on another thread than its parent's (given as ``parent``) reads
  the host clock only and opens no range: a range opened on a pool thread
  does not reach ``torch.profiler``'s trace.
* A **counter** adds to ``totals["count/<name>"]`` (``counts``: the adds).

Spans nest: each knows its parent (the span open on its thread, or the one
given) and the request it belongs to. ``request`` opens a request record
with a sequence number; ``requests`` keeps the last ``REQUESTS_KEPT``. A
stage or span that raises is recorded all the same.
"""

from __future__ import annotations

import contextlib
import itertools
import logging
import threading
import time
from collections import defaultdict, deque
from dataclasses import dataclass, field

import torch

logger = logging.getLogger("nesr.profiler")

__all__ = ["StageTimer", "Span", "RequestRecord", "NULL_TIMER"]

REQUESTS_KEPT = 16      # request records a timer keeps
SPANS_KEPT = 4096       # span records a request keeps
EVENTS_KEPT = 1024      # free timing events a device keeps
PENDING_KEPT = 4096     # event pairs awaiting their request's end


def _sync(devices) -> int:
    """Wait for the CUDA devices among ``devices``, or for the current GPU
    when ``devices`` is None; returns the number of devices waited for."""
    if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
        return 0
    if devices is None:
        torch.cuda.synchronize()
        return 1
    n = 0
    for device in dict.fromkeys(torch.device(d) for d in devices):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            n += 1
    return n


# True while a torch.profiler is recording: a range is opened only then
# (a record_function costs ~10 us of host time even when nothing records)
_profiling = getattr(torch._C._autograd, "_profiler_enabled", lambda: True)


def _range(name: str):
    if _profiling():
        return torch.profiler.record_function(f"nesr/{name}")
    return contextlib.nullcontext()


def _event():
    return torch.cuda.Event(enable_timing=True, blocking=True)


def _stream(device):
    return torch.cuda.current_stream(device)


@dataclass(eq=False)
class Span:
    """One stage or span: its parent span, its request's id, its thread,
    host seconds, device seconds (None until read, or on the host clock
    only) and, while open, the host seconds its children on its own thread
    covered."""
    name: str
    parent: "Span | None"
    request: int | None
    thread: int
    host_s: float = 0.0
    device_s: float | None = None
    child_s: float = 0.0


@dataclass(eq=False)
class RequestRecord:
    id: int
    spans: list = field(default_factory=list)


class StageTimer:
    """The per-stage and per-span totals of a pipeline, and its records of
    recent requests."""

    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)
        self.requests: deque = deque(maxlen=REQUESTS_KEPT)
        self._self_s: dict[str, float] = defaultdict(float)
        self._lock = threading.Lock()
        self._local = threading.local()
        self._ids = itertools.count()
        self._record: RequestRecord | None = None
        self._home: torch.device | None = None   # the clock's device
        self._free: dict = defaultdict(list)      # device -> free events
        self._pending: list = []                  # (span, start, end, device)

    # ------------------------------------------------------------ spans --

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def current(self) -> Span | None:
        """The span open on the calling thread, if any."""
        stack = self._stack()
        return stack[-1] if stack else None

    def _clock(self, devices):
        """The device whose clock a span reads: the home device inside a
        request when every device of ``devices`` (None: the home device)
        is the home device; else None, the host clock only."""
        if self._home is None:
            return None
        if devices is not None and any(torch.device(d) != self._home
                                       for d in devices):
            return None
        return self._home

    def _mark(self, device):
        free = self._free[device]
        ev = free.pop() if free else _event()
        ev.record(_stream(device))
        return ev

    def _open(self, name, parent, devices) -> tuple:
        stack = self._stack()
        sp = Span(name, parent if parent is not None
                  else (stack[-1] if stack else None),
                  self._record.id if self._record is not None else None,
                  threading.get_ident())
        dev = self._clock(devices) if parent is None else None
        stack.append(sp)
        return sp, dev, (self._mark(dev) if dev is not None else None)

    def _close(self, sp, dev, start, end, dt) -> None:
        stack = self._stack()
        if stack and stack[-1] is sp:
            stack.pop()
        if end is not None:
            self._pending.append((sp, start, end, dev))
        sp.host_s = dt
        with self._lock:
            self.totals[sp.name] += dt
            self.counts[sp.name] += 1
            self._self_s[sp.name] += max(0.0, dt - sp.child_s)
            parent = sp.parent
            if parent is not None and parent.thread == sp.thread:
                parent.child_s += dt
            rec = self._record
            if rec is not None and len(rec.spans) < SPANS_KEPT:
                rec.spans.append(sp)

    @contextlib.contextmanager
    def span(self, name: str, device=None, parent: Span | None = None):
        """A span ``name`` around the block; yields its record. ``device``:
        the device its work runs on (the home device when None); only the
        home device's clock is read. ``parent``: the span that caused this
        one, on another thread (see the module's doc)."""
        sp, dev, start = self._open(
            name, parent, None if device is None else (device,))
        t0 = time.perf_counter()
        end = None
        try:
            if parent is None:
                with _range(name):
                    yield sp
            else:
                yield sp
        finally:
            if start is not None:
                end = self._mark(dev)
            self._close(sp, dev, start, end, time.perf_counter() - t0)

    def _wait(self, devices) -> None:
        t0 = time.perf_counter()
        n = _sync(devices)
        if n:
            with self._lock:
                self.totals["sync"] += time.perf_counter() - t0
                self.counts["sync"] += n

    @contextlib.contextmanager
    def stage(self, name: str, sync_start: bool = True,
              sync_end: bool = True, devices=None):
        """A span whose ends synchronise (see the module's doc): the host
        clock starts after the first wait and stops after the last; the
        device clock and the range end before it. The device clock is read
        only when every device of ``devices`` is the home device."""
        if sync_start:
            self._wait(devices)
        t0 = time.perf_counter()
        sp, dev, start = self._open(name, None, devices)
        end = None
        try:
            with _range(name):
                yield sp
        finally:
            # Record even when the stage raises: a failing stage must show
            # up in the table, not vanish.
            try:
                if start is not None:
                    end = self._mark(dev)
                if sync_end:
                    self._wait(devices)
            finally:
                self._close(sp, dev, start, end, time.perf_counter() - t0)

    def count(self, name: str, value) -> None:
        """Add ``value`` to the counter ``count/<name>``."""
        with self._lock:
            self.totals[f"count/{name}"] += value
            self.counts[f"count/{name}"] += 1

    # ---------------------------------------------------------- requests --

    @contextlib.contextmanager
    def request(self, home=None):
        """One request: a record with the next sequence number and the
        span ``request`` (host clock); on a CUDA ``home`` device its spans
        read the device's clock too, in one batch when it ends without an
        error (after its last wait: nothing blocks)."""
        outer = (self._record, self._home)
        self._record = RequestRecord(next(self._ids))
        self.requests.append(self._record)
        self._home = None
        try:
            # opened before the home is set: its end would run after the
            # request's last wait
            with self.span("request"):
                home = None if home is None else torch.device(home)
                if home is not None and home.type == "cuda":
                    self._home = home
                yield self._record
            self.resolve()
        finally:
            self._record, self._home = outer

    def resolve(self) -> None:
        """Read the device clocks of finished spans into the totals; the
        pairs whose end has not run yet stay for the next call. Never
        waits."""
        keep = []
        for sp, start, end, dev in self._pending:
            if not end.query():
                keep.append((sp, start, end, dev))
                continue
            sp.device_s = start.elapsed_time(end) / 1e3
            with self._lock:
                self.totals[f"device/{sp.name}"] += sp.device_s
                self.counts[f"device/{sp.name}"] += 1
            free = self._free[dev]
            if len(free) < EVENTS_KEPT:
                free.extend((start, end))
        self._pending = keep[-PENDING_KEPT:]

    # ----------------------------------------------------------- summary --

    def summary_lines(self) -> list[str]:
        """A line a span (host seconds, calls, self seconds where children
        on its thread covered part of it, device seconds), then the
        counters and the waits."""
        spans = {k: v for k, v in self.totals.items()
                 if not k.startswith(("device/", "count/")) and k != "sync"}
        lines = [f"  {'span':<26s} {'host s':>9s} {'calls':>6s} "
                 f"{'self s':>9s} {'device s':>9s}"]
        for name, t in sorted(spans.items(), key=lambda kv: -kv[1]):
            dev = self.totals.get(f"device/{name}")
            lines.append(
                f"  {name:<26s} {t:9.3f} {self.counts[name]:6d} "
                f"{self._self_s.get(name, t):9.3f} "
                f"{'' if dev is None else f'{dev:9.3f}':>9s}")
        for name, v in sorted(self.totals.items()):
            if name.startswith("count/"):
                lines.append(f"  {name:<26s} {v:14.0f} "
                             f"({self.counts[name]} adds)")
        if "sync" in self.totals:
            lines.append(f"  {'sync (waits)':<26s} {self.totals['sync']:9.3f}"
                         f" {self.counts['sync']:6d}")
        return lines

    def log_summary(self):
        for line in self.summary_lines():
            logger.info(line)


class _NullTimer:
    """What a tiled path or the diffusion pipeline times with when no
    timer was given: spans and counters that record nothing."""

    def span(self, name, device=None, parent=None):
        return contextlib.nullcontext()

    def count(self, name, value) -> None:
        pass

    def current(self):
        return None


NULL_TIMER = _NullTimer()
