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
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from contextlib import contextmanager

logger = logging.getLogger("tantivy_tpu_torch")


class Tracer:
    """Per-process span collector (chrome-trace "X" complete events)."""

    def __init__(self):
        self.enabled = os.environ.get("TANTIVY_TPU_TRACE", "") not in ("", "0")
        self._events: list[dict] = []
        self._lock = threading.Lock()
        self._t0 = time.perf_counter()

    def enable(self) -> None:
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def clear(self) -> None:
        with self._lock:
            self._events = []

    def record(self, name: str, start_s: float, dur_s: float,
               **args) -> None:
        if not self.enabled:
            return
        with self._lock:
            self._events.append(
                {
                    "name": name,
                    "ph": "X",
                    "ts": (start_s - self._t0) * 1e6,
                    "dur": dur_s * 1e6,
                    "pid": os.getpid(),
                    "tid": threading.get_ident() & 0xFFFF,
                    "args": args,
                }
            )

    @property
    def events(self) -> list[dict]:
        with self._lock:
            return list(self._events)

    def dump_chrome_trace(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump({"traceEvents": self.events}, f)

    def span_totals(self) -> dict[str, float]:
        """name -> total seconds across events (quick profiling summary)."""
        out: dict[str, float] = {}
        for e in self.events:
            out[e["name"]] = out.get(e["name"], 0.0) + e["dur"] / 1e6
        return out


tracer = Tracer()


@contextmanager
def debug_time(name: str, **args):
    """Span context manager: logs at DEBUG and records into the tracer."""
    start = time.perf_counter()
    try:
        yield
    finally:
        dur = time.perf_counter() - start
        if tracer.enabled:
            tracer.record(name, start, dur, **args)
        if logger.isEnabledFor(logging.DEBUG):
            logger.debug("%s: %.3f ms", name, dur * 1e3)
