"""Planner: phase-2 planning of the fused chains, ms a batch: the time
under the spans `bool.phase2` and `phrase.phase2` (thresholds, survivor
selection, the ratchet's cut) less the dispatch, collect, `launch.*` and
`probe.*` spans inside them."""

from searchbench import batch_spans as bs

PHASE2 = ("bool.phase2", "phrase.phase2")
#: the spans under them that belong to other layers
CHILDREN = ("bool.fused_dispatch", "bool.probe_dispatch", "bool.collect",
            "phrase.dispatch", "phrase.collect", "launch.", "probe.")


def read(trace):
    return bs.ms_per_batch(trace,
                           lambda b: bs.self_time(b, PHASE2, CHILDREN))
