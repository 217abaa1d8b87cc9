"""Device: one minus the time in which a kernel or a copy ran on the
device over the wall time of the batches traced whole, in percent."""

from searchbench import tracebook as tb


def read(trace):
    batches = tb.complete(trace)
    wall = sum(b["t1"] - b["t0"] for b in batches)
    if wall <= 0:
        return None
    busy = sum(tb.length(tb.busy(b)) for b in batches)
    return 100.0 * (1.0 - busy / wall)
