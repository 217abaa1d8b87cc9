"""Shared set-up of the benchmark's CPU tests: a benchmark of tiny cells
(`tiny_bench`) that runs the port's plain versions in seconds."""

import io
import json
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs a CUDA device (the port's kernels have no CPU mode); "
        "skips where none is present",
    )


#: the seed of every tiny cell's run
SEED = 2**31 + 99

TINY_CORPUS = {"vocab": 400, "stream_tokens": 20000, "docs": 1200,
               "segments": 4,
               "doc_len": {"dist": "loguniform", "lo": 5, "hi": 400}}
#: a one-field configuration's `fields`
BODY = [{"name": "body"}]
#: a title + body configuration's `fields`: titles of 3-15 tokens, the
#: body as TINY_CORPUS gives it
TITLE_BODY = [{"name": "title",
               "doc_len": {"dist": "uniform", "lo": 3, "hi": 16}},
              {"name": "body"}]


def write_tiny_bench(path, mixes: dict, fields: list | None = None) -> dict:
    """A BENCHMARK.json under `path` with the real metrics and one tiny
    cell a mix of `mixes` ({name: mix}), over a tiny corpus of one `body`
    field, or of the text `fields` given."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        real = json.load(f)
    os.makedirs(os.path.join(path, "configs"), exist_ok=True)
    os.makedirs(os.path.join(path, "traffic"), exist_ok=True)
    cfg = {"name": "tiny", "corpus": TINY_CORPUS}
    cfg.update({"fields": fields} if fields else {"field": "body"})
    with open(os.path.join(path, "configs", "tiny.json"), "w") as f:
        json.dump(cfg, f)
    cells = []
    for name, mix in mixes.items():
        with open(os.path.join(path, "traffic", f"{name}.json"), "w") as f:
            json.dump(mix, f)
        cells.append({"name": f"tiny.{name}", "config": "tiny",
                      "traffic": name, "chips": 1, "why": "test"})
    bench = dict(real, workloads=cells,
                 configs=[{"name": "tiny", "source": "test",
                           "file": "configs/tiny.json", "reduced": [],
                           "why": "test"}])
    names = [c["name"] for c in cells]
    bench["per_layer"] = [dict(m, workloads=names) for m in real["per_layer"]]
    with open(os.path.join(path, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return bench


def run_cell(bench, workload, trace=False, seconds=1.0, device="cpu"):
    """One run of a tiny cell of the benchmark under `bench`: (exit code,
    result line or None, standard error)."""
    from searchbench.harness import Run

    out, err = io.StringIO(), io.StringIO()
    rc = Run(workload, SEED, seconds, trace, device=device, root=bench,
             data_dir=bench, err=err).execute(out)
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None), err.getvalue()


def small_mix(mix_name: str, batch: int) -> dict:
    """A real mix from `traffic/`, at a smaller batch and sample."""
    with open(os.path.join(ROOT, "searchbench", "traffic",
                           f"{mix_name}.json")) as f:
        mix = json.load(f)
    return dict(mix, batch=batch, check_sample=batch)


@pytest.fixture
def tiny_bench(tmp_path):
    write_tiny_bench(tmp_path, {
        "questions": small_mix("questions", 24),
        "phrase": small_mix("phrase", 24),
        "union": small_mix("union", 24),
    })
    return str(tmp_path)


@pytest.fixture
def title_body_bench(tmp_path):
    write_tiny_bench(tmp_path, {
        "questions": small_mix("questions", 24),
        "phrase": small_mix("phrase", 24),
    }, fields=TITLE_BODY)
    return str(tmp_path)
