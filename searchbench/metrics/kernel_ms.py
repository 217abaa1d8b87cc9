"""Kernels: device time of the port's kernels (K1-K8, by function name)
from torch.profiler, ms a batch over the batches traced whole."""

from searchbench import tracebook as tb


def read(trace):
    batches = tb.complete(trace)
    if not batches:
        return None
    t = tb.device_time(batches, lambda op: tb.kernel_of(trace, op))
    return 1e3 * t / len(batches)
