"""Planner: the self time of the port's planner spans, ms a batch; the
dispatch and collect spans inside them are taken out."""

from searchbench import tracebook as tb

#: the planner's spans (`parallel/__init__.py`)
PLAN = ("bool.plan_", "phrase.plan", "phrase_seg.plan_", "term.plan_")
#: the spans under them that belong to other layers
CHILDREN = ("bool.fused_dispatch", "bool.probe_dispatch", "bool.collect",
            "phrase.dispatch", "phrase.collect", "phrase_seg.dispatch",
            "phrase_seg.collect", "term.collect", "probe.", "launch.")


def read(trace):
    batches = trace["batches"]
    if not batches:
        return None
    total = 0.0
    for b in batches:
        plan = tb.union(tb.spans_named(b, PLAN))
        inner = tb.intersect(plan, tb.spans_named(b, CHILDREN))
        total += tb.length(plan) - tb.length(inner)
    return 1e3 * total / len(batches)
