"""Query parser: the benchmark's own span around its `parse_query` calls,
ms a batch."""


def read(trace):
    batches = trace["batches"]
    if not batches:
        return None
    return 1e3 * sum(b["parse_s"] for b in batches) / len(batches)
