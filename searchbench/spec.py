"""Finds what `BENCHMARK.json` names, by name: a cell's configuration
(`configs/<name>.json`), its traffic mix (`traffic/<name>.json`) and the
reader of each per-layer metric (`metrics/<name>.py`). A new
configuration, mix or metric is a new file and an entry, and needs no
edit here.

A configuration file holds `corpus` (`vocab`, `stream_tokens`, `docs`,
`segments`, `doc_len`: see `corpus.py`) and its text fields, in one of two
forms:

* `"field": "body"`: one TEXT field;
* `"fields": [{"name": "title", "doc_len": {...}}, {"name": "body"}]`:
  several TEXT fields, in the query parser's default-field order. Exactly
  one leaves out `doc_len` and takes the corpus's lengths and windows; each
  other field draws its lengths from its own `doc_len` and its window from
  inside that field's window (`corpus.make_corpus`).

The index holds one TEXT field an entry, in order, and the parser searches
them all, as tantivy's `QueryParser::for_index(&index, vec![title, body])`
does; `reference.py` scores what that parser builds. The rest of the file
(`source`, `published`, `reduced`, `assumed`, `guarantees`, `similarity`)
states the deployment for its readers."""

from __future__ import annotations

import importlib.util
import json
import os

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def config(name: str, bench_dir: str = BENCH_DIR) -> dict:
    return load_json(os.path.join(bench_dir, "configs", f"{name}.json"))


def traffic(name: str, bench_dir: str = BENCH_DIR) -> dict:
    return load_json(os.path.join(bench_dir, "traffic", f"{name}.json"))


def reader(metric: str, bench_dir: str = BENCH_DIR):
    """The module `metrics/<metric>.py`, whose `read(trace)` gives the
    metric's value, or None where the trace holds nothing to read."""
    path = os.path.join(bench_dir, "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(
        f"searchbench_metric_{metric.replace('.', '_').replace('-', '_')}",
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One entry of `workloads` with what it names."""

    def __init__(self, bench: dict, workload: str,
                 data_dir: str = BENCH_DIR):
        cells = {w["name"]: w for w in bench["workloads"]}
        if workload not in cells:
            raise KeyError(f"no workload {workload!r}; "
                           f"workloads: {sorted(cells)}")
        self.entry = w = cells[workload]
        self.name = workload
        self.chips = w["chips"]
        self.config = config(w["config"], data_dir)
        self.mix = traffic(w["traffic"], data_dir)

        def here(m):
            return workload in m.get("workloads", [workload])

        self.end_to_end = [m for m in bench["end_to_end"] if here(m)]
        self.per_layer = [m for m in bench["per_layer"] if here(m)]
