"""The port imports torch and never jax: importing `tantivy_tpu_torch` and
each of its modules, and running its phrase path on the CPU, must leave
`jax`, and every `tantivy_tpu.ops` module other than the numpy
`fused_store`, out of `sys.modules`; so must running its per-segment
boolean path.

Runs in a fresh interpreter, because this test process has already
imported jax (tests/conftest.py)."""

import os
import subprocess
import sys

MODULES = (
    "tantivy_tpu_torch",
    "tantivy_tpu_torch.ops._build",
    "tantivy_tpu_torch.ops.bool_probe",
    "tantivy_tpu_torch.ops.device_index",
    "tantivy_tpu_torch.ops.fmath",
    "tantivy_tpu_torch.ops.fused_bool",
    "tantivy_tpu_torch.ops.fused_phrase",
    "tantivy_tpu_torch.ops.fused_store",
    "tantivy_tpu_torch.ops.group_probe",
    "tantivy_tpu_torch.ops.phrase_probe",
    "tantivy_tpu_torch.ops.probe_scorer",
    "tantivy_tpu_torch.parallel",
)

LOADED = """
bad = sorted(
    m for m in sys.modules
    if m == "jax" or m.startswith("jax.")
    or (m.startswith("tantivy_tpu.ops.") and m != "tantivy_tpu.ops.fused_store")
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

#: the per-segment Block-WAND path (K3's twin and the deep probe) on the CPU
PROBE_RUN = """
import sys
import tantivy_tpu_torch as tt
from tantivy_tpu_torch.ops import bool_probe

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
ex = tt.BatchExecutor(searcher, device="cpu")
got = ex.search_boolean_batch(queries, 5)
for q, hits in zip(queries, got):
    assert hits == searcher.search(q, tt.TopDocs(5)), q
assert ex.plan_stats.get("probe_deep", 0) > 0, ex.plan_stats
assert bool_probe.launches == 0
""" + LOADED


def _run(program, *args):
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    out = subprocess.run(
        [sys.executable, "-c", program, *args],
        capture_output=True, text=True, cwd=root, env=env, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "", f"loaded: {out.stdout.strip()}"


def test_port_imports_no_jax():
    _run(PROGRAM, *MODULES)


def test_phrase_path_runs_without_jax():
    _run(PHRASE_RUN)


def test_probe_path_runs_without_jax():
    _run(PROBE_RUN)
