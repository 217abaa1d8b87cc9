"""Launch assembly: the time covered by the port's dispatch spans (and
the launch spans inside them), ms a batch."""

from searchbench import tracebook as tb

#: the launch-assembly spans (`parallel/__init__.py`, `ops/*.py`)
DISPATCH = ("bool.fused_dispatch", "bool.probe_dispatch", "phrase.dispatch",
            "phrase_seg.dispatch", "probe.")


def read(trace):
    batches = trace["batches"]
    if not batches:
        return None
    total = sum(tb.length(tb.spans_named(b, DISPATCH)) for b in batches)
    return 1e3 * total / len(batches)
