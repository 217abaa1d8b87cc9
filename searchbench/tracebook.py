"""What a traced run records, and the arithmetic its metric readers share.

A trace is a dict:

* `batches`: one dict a traced batch, with `t0` and `t1` (host clock,
  seconds, from before parsing to after the device synchronised), `queries`,
  `parse_s`, `spans` ([name, start, end] of the program's host spans and
  the benchmark's `searchbench.parse`, on the same clock), `device`
  ([name, start, end] of each device operation the profiler saw, moved to
  the host clock, or None where the batch was not profiled), `complete`
  (the profiler saw as many launches of the port's kernels as the port
  counted), `launches` and `bytes` ({kernel: count or least bytes} of the
  batch);
* `plans` and `host_plans`: (query, segment) plans of the traced window,
  and those the executor answered on the host engine;
* `kernels`: {kernel function: port kernel name} (`kernels.json`);
* `hbm_bytes_per_s`: the card's memory bandwidth (`peaks.json`).
"""

from __future__ import annotations

import re

_MANGLED = re.compile(r"_Z(\d+)")
_IDENT = re.compile(r"[A-Za-z_][\w:]*")


def union(intervals) -> list[tuple[float, float]]:
    """The disjoint, sorted intervals that `intervals` cover together."""
    out: list[list[float]] = []
    for lo, hi in sorted((float(a), float(b)) for a, b in intervals):
        if hi <= lo:
            continue
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return [(a, b) for a, b in out]


def length(intervals) -> float:
    return sum(b - a for a, b in union(intervals))


def intersect(xs, ys) -> list[tuple[float, float]]:
    """The intersection of two unions of intervals."""
    xs, ys = union(xs), union(ys)
    out, i, j = [], 0, 0
    while i < len(xs) and j < len(ys):
        lo = max(xs[i][0], ys[j][0])
        hi = min(xs[i][1], ys[j][1])
        if hi > lo:
            out.append((lo, hi))
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return out


def spans_named(batch: dict, prefixes) -> list[tuple[float, float]]:
    return [(s, e) for name, s, e in batch["spans"]
            if name.startswith(tuple(prefixes))]


def function_name(op: str) -> str:
    """A kernel's function name from the profiler's name for it, demangled
    (`void k<1>(int const*)`) or not (`_Z1kPKi`)."""
    s = op.replace("(anonymous namespace)::", "").strip()
    if s.startswith("void "):
        s = s[5:]
    m = _MANGLED.match(s)
    if m:
        return s[m.end():m.end() + int(m.group(1))]
    m = _IDENT.match(s)
    return m.group(0).split("::")[-1] if m else s


def kernel_of(trace: dict, op: str) -> str | None:
    """The port kernel that a device operation is, or None."""
    return trace["kernels"].get(function_name(op))


def complete(trace: dict) -> list[dict]:
    """The batches whose device trace is whole."""
    return [b for b in trace["batches"]
            if b["device"] is not None and b["complete"]]


def device_time(batches, keep) -> float:
    """Seconds of device operations whose name `keep` accepts."""
    return sum(e - s for b in batches for name, s, e in b["device"]
               if keep(name))


def is_h2d(op: str) -> bool:
    return op.startswith("Memcpy HtoD")


def busy(batch: dict) -> list[tuple[float, float]]:
    """Where some operation ran on the device during the batch."""
    return intersect([(s, e) for _, s, e in batch["device"]],
                     [(batch["t0"], batch["t1"])])


def roofline_pct(trace: dict, kernels=None) -> float | None:
    """The least time of the whole batches' launches of `kernels` (all the
    kernels with byte counts when None) at the card's memory bandwidth,
    over their device time, in percent; None where they did not run."""
    batches = complete(trace)
    counted = {k for b in batches for k in b["bytes"]}
    if kernels is not None:
        counted &= set(kernels)
    n_bytes = sum(b["bytes"].get(k, 0) for b in batches for k in counted)
    t = device_time(batches, lambda op: kernel_of(trace, op) in counted)
    if not counted or t <= 0 or n_bytes <= 0:
        return None
    return 100.0 * n_bytes / trace["hbm_bytes_per_s"] / t


def innermost(spans, t: float) -> str | None:
    """The shortest span open at time `t`."""
    best = None
    for name, s, e in spans:
        if s <= t < e and (best is None or e - s < best[1]):
            best = (name, e - s)
    return best[0] if best else None


def idle_by_span(batch: dict) -> dict[str, float]:
    """Seconds of the batch in which the device was idle, by the innermost
    host span open at the time."""
    idle, at = [], batch["t0"]
    for s, e in busy(batch):
        idle.append((at, s))
        at = e
    idle.append((at, batch["t1"]))
    out: dict[str, float] = {}
    cuts = sorted({x for _, s, e in batch["spans"] for x in (s, e)})
    for lo, hi in idle:
        if hi <= lo:
            continue
        edges = [lo] + [x for x in cuts if lo < x < hi] + [hi]
        for a, b in zip(edges, edges[1:]):
            name = innermost(batch["spans"], (a + b) / 2) or "host, no span"
            out[name] = out.get(name, 0.0) + (b - a)
    return out


def breakdown(trace: dict, top: int = 10) -> dict | None:
    """The device operations that took most time, by name, and the idle
    time by what the host was doing, over the whole batches."""
    batches = complete(trace)
    if not batches:
        return None
    ops: dict[str, float] = {}
    for b in batches:
        for name, s, e in b["device"]:
            key = name if name.startswith("Mem") else function_name(name)
            ops[key] = ops.get(key, 0.0) + (e - s)
    idle: dict[str, float] = {}
    for b in batches:
        for name, sec in idle_by_span(b).items():
            idle[name] = idle.get(name, 0.0) + sec

    def ranked(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])
                ][:top]

    return {"device_ops": ranked(ops), "idle_gaps": ranked(idle)}
