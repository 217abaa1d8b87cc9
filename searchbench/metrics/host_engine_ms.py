"""Host engine: the time under the port's `host.search` (queries routed
to the host engine) and `host.segment_topk` (a (query, segment) plan the
device cannot run) spans, ms a batch; 0.0 where none ran."""

from searchbench import batch_spans as bs

HOST = ("host.search", "host.segment_topk")


def read(trace):
    return bs.ms_per_batch(trace, lambda b: bs.covered(b, HOST))
