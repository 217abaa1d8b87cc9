"""Planner: the fused chains freeing their plans' per-item arrays at the
end of each chain, ms a batch: the time under the port's spans
`bool.release` and `phrase.release`."""

from searchbench import batch_spans as bs

RELEASE = ("bool.release", "phrase.release")


def read(trace):
    return bs.ms_per_batch(trace, lambda b: bs.covered(b, RELEASE))
