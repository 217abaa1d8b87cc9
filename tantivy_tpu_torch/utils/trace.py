"""Lightweight tracing/profiling — counterpart of the reference's `log`
macros + `debug_time!` spans (`merger.rs:657`) plus a chrome-trace exporter
the reference lacks (useful for batched-device timelines).

Usage:
    from tantivy_tpu_torch.utils.trace import debug_time, tracer

    with debug_time("write-postings-for-field"):
        ...
    tracer.dump_chrome_trace("/tmp/trace.json")   # chrome://tracing format

Spans nest; collection is enabled via `tracer.enable()` or the
TANTIVY_TPU_TRACE=1 environment variable, and is close to free when
disabled (one attribute check).

Events are stamped on torch.profiler's clock: an event's `ts` is Unix-epoch
microseconds, as kineto stamps a profile's events (`start_ns()` of
`profile.profiler.kineto_results.events()`), so the spans and a profile's
host and device events share one timeline
(`tracer.dump_chrome_trace(path, profile=prof)` writes both into one file).
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time

logger = logging.getLogger("tantivy_tpu_torch")


class Tracer:
    """Per-process span collector (chrome-trace "X" complete events) and
    counters, both recorded only while tracing is on. A span is kept as a
    tuple of plain values, which the garbage collector soon stops
    tracking, and becomes an event dict when `events` is read. A counter
    keeps each increment with its time, so a reader sums those of the
    stretch it reads (`counted`)."""

    def __init__(self):
        self.enabled = False
        # (name, ts us, dur us, thread, args or None)
        self._spans: list[tuple] = []
        # (name, time.perf_counter() s, n)
        self._counts: list[tuple] = []
        self._lock = threading.Lock()
        self._perf_s = 0.0
        self._epoch_us = 0.0
        self._pid = os.getpid()
        if os.environ.get("TANTIVY_TPU_TRACE", "") not in ("", "0"):
            self.enable()

    def enable(self) -> None:
        """Turn tracing on, taking the anchor that maps
        `time.perf_counter()` onto the profiler's epoch clock."""
        if not self.enabled:
            p0 = time.perf_counter_ns()
            epoch_ns = time.time_ns()
            p1 = time.perf_counter_ns()
            self._perf_s = (p0 + p1) / 2e9
            self._epoch_us = epoch_ns / 1e3
            self._pid = os.getpid()
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def clear(self) -> None:
        """Drop the recorded spans; the counters' increments stay, each
        read by the stretch of time it fell in."""
        with self._lock:
            self._spans = []

    def clock_us(self, perf_s: float) -> float:
        """A `time.perf_counter()` reading on the profiler's clock, in
        Unix-epoch microseconds."""
        return self._epoch_us + (perf_s - self._perf_s) * 1e6

    def record(self, name: str, start_s: float, dur_s: float,
               **args) -> None:
        """A span from `start_s` (`time.perf_counter()` seconds) lasting
        `dur_s` seconds."""
        if not self.enabled:
            return
        span = (name, self.clock_us(start_s), dur_s * 1e6,
                threading.get_ident() & 0xFFFF, args or None)
        with self._lock:
            self._spans.append(span)

    def count(self, name: str, n: int = 1) -> None:
        """Add `n` to counter `name`, now."""
        if not self.enabled:
            return
        sample = (name, time.perf_counter(), n)
        with self._lock:
            self._counts.append(sample)

    @property
    def events(self) -> list[dict]:
        with self._lock:
            spans = list(self._spans)
        return [{"name": name, "ph": "X", "ts": ts, "dur": dur,
                 "pid": self._pid, "tid": tid, "args": args or {}}
                for name, ts, dur, tid, args in spans]

    def counted(self, name: str, start_s: float, end_s: float) -> int:
        """Counter `name`'s increments from `start_s` to `end_s`
        (`time.perf_counter()` seconds)."""
        with self._lock:
            samples = list(self._counts)
        return sum(n for key, t, n in samples
                   if key == name and start_s <= t <= end_s)

    def dump_chrome_trace(self, path: str, profile=None) -> None:
        """The spans as a chrome trace; with `profile`, a finished
        `torch.profiler.profile`, its events too (kernels and copies on
        the card, by device and stream; host operations where it traced
        the CPU), on the same clock."""
        events = self.events
        if profile is not None:
            events += profile_events(profile)
        with open(path, "w") as f:
            json.dump({"traceEvents": events}, f)

    def span_totals(self) -> dict[str, float]:
        """name -> total seconds across events (quick profiling summary)."""
        out: dict[str, float] = {}
        for e in self.events:
            out[e["name"]] = out.get(e["name"], 0.0) + e["dur"] / 1e6
        return out


def profile_events(profile) -> list[dict]:
    """A finished torch.profiler session's events as chrome-trace "X"
    events in Unix-epoch microseconds: a device's under `pid` "<device>
    <index>" and `tid` its stream, the host's under "profiler cpu" and
    the thread."""
    out = []
    for e in profile.profiler.kineto_results.events():
        kind = e.device_type().name.lower()
        if kind == "cpu":
            pid, tid = "profiler cpu", e.start_thread_id()
        else:
            pid, tid = f"{kind} {e.device_index()}", e.device_resource_id()
        out.append({"name": e.name(), "ph": "X", "ts": e.start_ns() / 1e3,
                    "dur": e.duration_ns() / 1e3, "pid": pid, "tid": tid,
                    "args": {}})
    return out


tracer = Tracer()


class debug_time:
    """Span context manager: logs at DEBUG and records into the tracer."""

    __slots__ = ("name", "args", "start")

    def __init__(self, name: str, **args):
        self.name = name
        self.args = args

    def __enter__(self) -> None:
        self.start = time.perf_counter()

    def __exit__(self, *exc) -> None:
        dur = time.perf_counter() - self.start
        if tracer.enabled:
            tracer.record(self.name, self.start, dur, **self.args)
        if logger.isEnabledFor(logging.DEBUG):
            logger.debug("%s: %.3f ms", self.name, dur * 1e3)
