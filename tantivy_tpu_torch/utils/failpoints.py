"""Failpoint injection framework.

Mirrors the role of the reference's `fail` crate integration
(`src/lib.rs:346-373` gates fail_point! sites; `tests/failpoints/mod.rs:7-124`
exercises crash-during-commit / delete-retry behavior): named points in
state-changing code paths can be armed, from code or from the environment,
to raise on hit. Tests use them to prove atomicity invariants — a crash
mid-commit leaves the previous meta.json live, a crash mid-merge leaves
both source segments searchable, a failed GC delete is retried later.

Actions (a string, like the fail crate's cfg grammar):

* ``off``            — disarmed (same as not configured)
* ``panic``          — raise :class:`FailPointPanic` (simulated crash)
* ``panic(msg)``     — same, with a message
* ``return``         — raise :class:`FailPointError` (recoverable failure)
* ``return(msg)``    — same, with a message
* ``N*<action>``     — fire ``<action>`` for the first N hits, then off

Environment: ``TANTIVY_TPU_FAILPOINTS="name=action;name2=action"`` arms
points at import time (the reference enables the equivalent via the
`failpoints` cargo feature).
"""

from __future__ import annotations

import os
import re
import threading

__all__ = [
    "FailPointError",
    "FailPointPanic",
    "fail_point",
    "cfg",
    "remove",
    "teardown",
    "active",
    "scenario",
]


class FailPointError(RuntimeError):
    """A *recoverable* injected failure (the `return` action): callers are
    expected to propagate it like any IO error."""


class FailPointPanic(BaseException):
    """A *crash* injected failure (the `panic` action). Derives from
    BaseException so ordinary `except Exception` recovery code cannot
    swallow it — like a process kill, only the test harness catches it."""


_lock = threading.Lock()
_points: dict[str, list] = {}  # name -> [action, msg, remaining or None]

_ACTION_RE = re.compile(
    r"^(?:(?P<count>\d+)\*)?(?P<verb>off|panic|return)"
    r"(?:\((?P<msg>[^)]*)\))?$"
)


def cfg(name: str, action: str) -> None:
    """Arm failpoint `name` with `action` (see module docstring grammar)."""
    m = _ACTION_RE.match(action.strip())
    if m is None:
        raise ValueError(f"bad failpoint action: {action!r}")
    verb = m.group("verb")
    count = m.group("count")
    with _lock:
        if verb == "off":
            _points.pop(name, None)
        else:
            _points[name] = [
                verb,
                m.group("msg") or name,
                int(count) if count is not None else None,
            ]


def remove(name: str) -> None:
    with _lock:
        _points.pop(name, None)


def teardown() -> None:
    """Disarm every failpoint (test cleanup)."""
    with _lock:
        _points.clear()


def active() -> dict[str, str]:
    with _lock:
        return {
            n: (f"{rem}*{verb}" if rem is not None else verb)
            for n, (verb, _msg, rem) in _points.items()
        }


def fail_point(name: str) -> None:
    """Evaluate failpoint `name`; no-op unless armed. Hot paths never call
    this — sites live only in commit/merge/GC/meta control flow, so the
    disarmed cost is one dict lookup."""
    with _lock:
        ent = _points.get(name)
        if ent is None:
            return
        verb, msg, remaining = ent
        if remaining is not None:
            if remaining <= 0:
                _points.pop(name, None)
                return
            ent[2] = remaining - 1
            if ent[2] == 0:
                # fire this hit, disarmed afterwards
                _points[name] = ["off_pending", msg, 0]
                _points.pop(name, None)
    if verb == "panic":
        raise FailPointPanic(msg)
    raise FailPointError(msg)


class scenario:
    """Context manager arming a set of failpoints and guaranteeing
    teardown: ``with scenario({"meta-file-write": "panic"}): ...``"""

    def __init__(self, points: dict[str, str]):
        self.points = points

    def __enter__(self):
        for n, a in self.points.items():
            cfg(n, a)
        return self

    def __exit__(self, *exc):
        teardown()
        return False


_env = os.environ.get("TANTIVY_TPU_FAILPOINTS", "")
if _env:
    for part in _env.split(";"):
        part = part.strip()
        if part:
            _name, _, _action = part.partition("=")
            cfg(_name.strip(), _action.strip() or "panic")
del _env
