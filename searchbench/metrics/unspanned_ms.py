"""Entry: the time inside the port's `batch.search` spans that no other
span of the program covers, ms a batch: what the per-layer spans do not
name."""

from searchbench import batch_spans as bs
from searchbench import tracebook as tb


def unspanned(batch):
    root = tb.union((s, e) for name, s, e in batch["spans"]
                    if name == bs.ROOT)
    inner = [(s, e) for name, s, e in batch["spans"] if name != bs.ROOT]
    return tb.length(root) - tb.length(tb.intersect(root, inner))


def read(trace):
    return bs.ms_per_batch(trace, unspanned)
