"""Device: device time of host-to-device copies from torch.profiler, ms a
batch over the batches traced whole."""

from searchbench import tracebook as tb


def read(trace):
    batches = tb.complete(trace)
    if not batches:
        return None
    return 1e3 * tb.device_time(batches, tb.is_h2d) / len(batches)
