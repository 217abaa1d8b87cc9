"""The port stands alone: it imports torch, never jax, and nothing of
`tantivy_tpu`. Importing every module of `tantivy_tpu_torch`, and running
its phrase path, its per-segment boolean path, the rest of its executor
(term batches, pipelined and sharded batches, count, agg, the warmer), its
per-segment phrase path, its packed mode and its entry points (`entry`,
`dryrun_multichip`) on the CPU, must leave no `jax` and no `tantivy_tpu` /
`tantivy_tpu.*` module in `sys.modules`; those run in a fresh interpreter,
because this test process has already imported both (tests/conftest.py). A static check parses every `.py` file of the
port, and `chip_smoke.py`, and fails on any import of `tantivy_tpu`."""

import ast
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "tantivy_tpu_torch")

#: every `.py` file of the port, relative to the repo root, and the smoke
SOURCES = sorted(
    os.path.relpath(os.path.join(d, f), ROOT)
    for d, _, files in os.walk(PKG) for f in files if f.endswith(".py")
) + ["chip_smoke.py"]

#: every module of the port, by its dotted name
MODULES = tuple(
    src[:-3].replace(os.sep, ".").removesuffix(".__init__")
    for src in SOURCES if src.startswith("tantivy_tpu_torch")
)

LOADED = """
bad = sorted(
    m for m in sys.modules
    if m in ("jax", "tantivy_tpu")
    or m.startswith(("jax.", "tantivy_tpu."))
)
print(" ".join(bad))
"""

PROGRAM = """
import importlib, sys
for name in sys.argv[1:]:
    importlib.import_module(name)
""" + LOADED

#: a phrase, a multi-term and a single-term phrase-prefix and a term query
#: through the port's executor on the CPU, on a small in-memory index
PHRASE_RUN = """
import sys
import tantivy_tpu_torch as tt
from tantivy_tpu_torch.ops import phrase_probe

b = tt.Schema.builder()
b.add_text_field("body", tt.TEXT)
index = tt.Index.create_in_ram(b.build())
w = index.writer_for_tests()
for i in range(300):
    w.add_document(tt.Document(body=f"a{i % 7} b{i % 5} a{i % 3} b{i % 2}"))
w.commit()
w.close()
searcher = index.reader().searcher()
queries = [
    tt.PhraseQuery("body", ["a1", "b1"]),
    tt.PhrasePrefixQuery("body", ["a1", "b"]),
    tt.PhrasePrefixQuery("body", ["a"]),
    tt.TermQuery(tt.Term.from_field_text("body", "b1")),
]
ex = tt.BatchExecutor(searcher, device="cpu")
ex.launch_log = []
got = ex.search_batch(queries, 5)
for q, hits in zip(queries, got):
    assert hits == searcher.search(q, tt.TopDocs(5)), q
assert any(r["kind"] == "phrase" for r in ex.launch_log)
assert ex.host_routed == 0 and phrase_probe.launches == 0
""" + LOADED

#: the per-segment Block-WAND path (the twins of K3 and of K4, the deep
#: probe) on the CPU
PROBE_RUN = """
import sys
import tantivy_tpu_torch as tt
from tantivy_tpu_torch.ops import bool_probe, deep_probe

b = tt.Schema.builder()
b.add_text_field("body", tt.TEXT)
index = tt.Index.create_in_ram(b.build())
w = index.writer_for_tests()
for i in range(9000):
    w.add_document(tt.Document(body="a h" if i % 3 == 0 else
                               ("a r" if i % 997 == 5 else "a")))
w.commit()
w.close()
searcher = index.reader().searcher()

def t(x):
    return tt.TermQuery(tt.Term.from_field_text("body", x))

queries = [tt.BooleanQuery.intersection([t("r"), t("a")]),
           tt.BooleanQuery.union([t("h"), t("r")])]
ex = tt.BatchExecutor(searcher, device="cpu", fused=False)
got = ex.search_boolean_batch(queries, 5)
for q, hits in zip(queries, got):
    assert hits == searcher.search(q, tt.TopDocs(5)), q
assert ex.plan_stats.get("probe_deep", 0) > 0, ex.plan_stats
assert bool_probe.launches == 0 and deep_probe.launches == 0
""" + LOADED


#: the per-segment phrase path (K6's twin) on the CPU
PHRASE_SEG_RUN = """
import sys
import tantivy_tpu_torch as tt
from tantivy_tpu_torch.ops import phrase_scorer

b = tt.Schema.builder()
b.add_text_field("body", tt.TEXT)
index = tt.Index.create_in_ram(b.build())
w = index.writer_for_tests()
for i in range(600):
    w.add_document(tt.Document(body=f"a{i % 7} b{i % 5} a{i % 3} b{i % 2}"))
w.commit()
w.close()
searcher = index.reader().searcher()
queries = [tt.PhraseQuery("body", ["a1", "b1"]),
           tt.PhraseQuery("body", ["b1", "a1", "b1"])]
ex = tt.BatchExecutor(searcher, device="cpu", fused=False)
got = ex.search_phrase_batch(queries, 5)
for q, hits in zip(queries, got):
    assert hits == searcher.search(q, tt.TopDocs(5)), q
assert ex.plan_stats.get("phrase_seg", 0) > 0, ex.plan_stats
assert phrase_scorer.launches == 0
""" + LOADED


#: the flat term scorer, pipelined batches, sharded search, count and agg
#: batches and the warmer on the CPU
SURFACE_RUN = """
import sys
import tantivy_tpu_torch as tt
from tantivy_tpu_torch.index import ReloadPolicy
from tantivy_tpu_torch.parallel import DeviceSearchWarmer
from tantivy_tpu_torch.parallel.shard import ShardedSearcher

b = tt.Schema.builder()
b.add_text_field("body", tt.TEXT)
b.add_u64_field("n", tt.FAST)
index = tt.Index.create_in_ram(b.build())
w = index.writer_for_tests()
for i in range(400):
    w.add_document(tt.Document(body=f"a{i % 7} b{i % 5}", n=i % 50))
    if i == 199:
        w.commit()
w.commit()
w.close()
warmer = DeviceSearchWarmer(["body"], device="cpu")
searcher = index.reader(ReloadPolicy.MANUAL, warmers=[warmer]).searcher()
ex = tt.BatchExecutor.for_searcher(searcher, device="cpu")
assert ex is searcher._warm_executor
terms = [tt.Term.from_field_text("body", f"a{i}") for i in range(7)]
queries = [tt.TermQuery(t) for t in terms]
want = [searcher.search(q, tt.TopDocs(5)) for q in queries]
assert ex.search_term_batch(terms, 5) == want
assert ex.search_batches([queries[:3], queries[3:]], 5, pipeline=2) == [
    want[:3], want[3:]]
assert ShardedSearcher(searcher, ["cpu", "cpu"]).search_batch(
    queries, 5) == want
q = tt.RangeQuery("n", 3, 9)
assert ex.count_batch([q]) == [searcher.search(q, tt.Count())]
req = {"s": {"stats": {"field": "n"}}}
assert ex.agg_batch([req]) == [
    searcher.search(tt.AllQuery(), tt.AggregationCollector(req))]
""" + LOADED


#: packed mode (K5's twin over the packed mirrors) and its warmer on the CPU
PACKED_RUN = """
import sys
import tantivy_tpu_torch as tt
from tantivy_tpu_torch.index import ReloadPolicy
from tantivy_tpu_torch.parallel import DeviceSearchWarmer

b = tt.Schema.builder()
b.add_text_field("body", tt.TEXT)
index = tt.Index.create_in_ram(b.build())
w = index.writer_for_tests()
for i in range(600):
    w.add_document(tt.Document(body=f"a{i % 7} b{i % 5} a{i % 3}"))
w.commit()
w.close()
warmer = DeviceSearchWarmer(["body"], device="cpu", mode="packed")
searcher = index.reader(ReloadPolicy.MANUAL, warmers=[warmer]).searcher()
ex = tt.BatchExecutor.for_searcher(searcher, device="cpu", mode="packed")
assert ex is searcher._warm_executor and ex._fused().cstore is None
terms = [tt.Term.from_field_text("body", f"a{i}") for i in range(7)]
queries = [tt.TermQuery(t) for t in terms]
want = [searcher.search(q, tt.TopDocs(5)) for q in queries]
assert ex.search_term_batch(terms, 5) == want
assert ex.search_batch(queries, 5) == want
""" + LOADED


#: the entry points (K7's twin under the term scorer) and its sharded dry
#: run on the CPU
ENTRY_RUN = """
import contextlib, io, sys
import torch
from tantivy_tpu_torch import entry
from tantivy_tpu_torch.ops import dense_flat

fn, args = entry.entry(device="cpu")
scores, docs = fn(*args)
assert scores.shape == (8, 10) and torch.isfinite(scores[:, 0]).all()
with contextlib.redirect_stdout(io.StringIO()):
    entry.dryrun_multichip(2, device="cpu")
assert dense_flat.launches == 0
""" + LOADED


def _run(program, *args):
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run(
        [sys.executable, "-c", program, *args],
        capture_output=True, text=True, cwd=ROOT, env=env, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "", f"loaded: {out.stdout.strip()}"


def test_port_imports_no_jax():
    assert len(MODULES) > 50, MODULES
    for name in ("entry", "ops.term_scorer", "ops.dense_flat"):
        assert f"tantivy_tpu_torch.{name}" in MODULES, name
    _run(PROGRAM, *MODULES)


def test_phrase_path_runs_without_jax():
    _run(PHRASE_RUN)


def test_probe_path_runs_without_jax():
    _run(PROBE_RUN)


def test_phrase_seg_path_runs_without_jax():
    _run(PHRASE_SEG_RUN)


def test_executor_surface_runs_without_jax():
    _run(SURFACE_RUN)


def test_packed_mode_runs_without_jax():
    _run(PACKED_RUN)


def test_entry_runs_without_jax():
    _run(ENTRY_RUN)


def _imports_reference(node) -> bool:
    if isinstance(node, ast.Import):
        names = [a.name for a in node.names]
    elif isinstance(node, ast.ImportFrom) and node.level == 0:
        names = [node.module or ""]
    else:
        return False
    return any(n == "tantivy_tpu" or n.startswith("tantivy_tpu.")
               for n in names)


@pytest.mark.parametrize("source", SOURCES)
def test_source_imports_no_reference(source):
    with open(os.path.join(ROOT, source)) as f:
        tree = ast.parse(f.read(), source)
    bad = [f"{source}:{n.lineno}" for n in ast.walk(tree)
           if _imports_reference(n)]
    assert not bad, f"imports of tantivy_tpu at {bad}"
