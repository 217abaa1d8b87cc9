"""One run of one cell: set-up, the measured window, the check against
the reference, and the result line.

The window drives the path a user of the library takes: each batch's
query strings go through `QueryParser.parse_query`, then through
`BatchExecutor(searcher, device=...).search_batch(queries, k)` on the
executor's default route, and the batch ends when the device has
synchronised. One caller sends its next batch when the last returns. The
window ends with the last batch that began in it.

`--trace 1` runs the same loop with the port's host spans on, a
torch.profiler session around each batch and the executor's launch log,
and reports the per-layer metrics instead of the end-to-end ones.
"""

from __future__ import annotations

import gc
import importlib
import json
import os
import sys
import time
import traceback

import numpy as np

from . import spec as specs
from . import tracebook
from .corpus import make_corpus, rng_for, text_fields
from .reference import Arith, Reference
from .roofline import launch_bytes
from .traffic import Traffic

#: top-level modules that may not be loaded once the window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "tantivy_tpu")
#: warm-up batches' purpose in `Traffic.batch_at`
WARM = 1
#: warm-up batches of the cell's own traffic before the window
WARM_BATCHES = 2


def process_age() -> float:
    """Seconds since this process started (from /proc, 10 ms steps)."""
    with open("/proc/self/stat") as f:
        start_ticks = float(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def zstd_codec() -> None:
    """The engine's host layers compress with the optional `zstandard`
    package; where it is missing, register an uncompressed stand-in (the
    index lives in this process's memory only). Copied from
    `chip_smoke.py`."""
    try:
        import zstandard  # noqa: F401

        return
    except ImportError:
        pass
    import types

    class ZstdCompressor:
        def __init__(self, level=3):
            self.level = level

        def compress(self, data):
            return bytes(data)

    class ZstdDecompressor:
        def decompress(self, data):
            return bytes(data)

    mod = types.ModuleType("zstandard")
    mod.ZstdCompressor = ZstdCompressor
    mod.ZstdDecompressor = ZstdDecompressor
    sys.modules["zstandard"] = mod


def build_index(corpus):
    """The corpus indexed by the program, one TEXT field a text field of
    the corpus, in order; one commit a segment, one indexing thread,
    nothing merged; the index lives in memory."""
    import tantivy_tpu_torch as tt

    b = tt.Schema.builder()
    for field in corpus.fields:
        b.add_text_field(field, tt.TEXT)
    index = tt.Index.create_in_ram(b.build())
    w = index.writer(memory_budget=2_000_000_000, num_threads=1,
                     merge_policy=tt.NoMergePolicy())
    n, per = corpus.n_docs, corpus.per_segment
    for i, doc in enumerate(corpus.documents()):
        w.add_document(tt.Document(**doc))
        if (i + 1) % per == 0 and i + 1 < n:
            w.commit()
    w.commit()
    w.close()
    return index


class Counters:
    """The port's kernel launch counters, by kernel name."""

    def __init__(self, kernels: dict):
        self.mods = {k: importlib.import_module(v["counter"])
                     for k, v in kernels.items()}

    def read(self) -> dict[str, int]:
        return {k: m.launches for k, m in self.mods.items()}


class Run:
    """One run of `workload`; `device` is "cuda" for the benchmark and
    "cpu" (the kernels' plain versions) in tests, which also give a
    `BENCHMARK.json` of their own (`root`) and the directory that holds
    its `configs/` and `traffic/` (`data_dir`)."""

    def __init__(self, workload: str, seed: int, seconds: float, trace: bool,
                 device: str = "cuda", root: str = specs.ROOT,
                 data_dir: str = specs.BENCH_DIR, err=sys.stderr):
        self.cell = specs.Cell(specs.benchmark(root), workload, data_dir)
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.device = device
        self.err = err
        kt = specs.load_json(os.path.join(specs.BENCH_DIR, "kernels.json"))
        self.kernels = kt["kernels"]
        self.functions = {fn: k for k, v in self.kernels.items()
                          for fn in v["functions"]}

    def say(self, *parts) -> None:
        print(*parts, file=self.err, flush=True)

    # -- set-up --------------------------------------------------------

    def setup(self) -> None:
        import torch

        from tantivy_tpu_torch.parallel import BatchExecutor
        from tantivy_tpu_torch.query.parser import QueryParser

        cfg, mix = self.cell.config, self.cell.mix
        self.corpus = make_corpus(cfg["corpus"], self.seed, text_fields(cfg))
        t = time.perf_counter()
        self.index = build_index(self.corpus)
        self.say(f"index: {self.corpus.n_docs} docs in "
                 f"{time.perf_counter() - t:.1f} s")
        self.searcher = self.index.reader().searcher()
        sizes = [r.max_doc for r in self.searcher.segment_readers()]
        self.n_segments = len(sizes)
        self.parser = QueryParser.for_index(self.index,
                                            list(self.corpus.fields))
        self.executor = BatchExecutor(self.searcher, device=self.device)
        self.traffic = Traffic(mix, self.corpus, self.seed)
        self.counters = Counters(self.kernels)
        if self.device == "cuda":
            torch.cuda.reset_peak_memory_stats()
        for i in range(WARM_BATCHES):
            _, t0, _, t1 = self.one_batch(self.traffic.batch_at(i, WARM))
        # the window's batches, made ahead for twice the batches that the
        # last warm batch's pace fits into it (more are made if needed)
        ahead = min(int(2 * self.seconds / max(t1 - t0, 1e-3)) + 4, 4096)
        self.log = [self.traffic.batch_at(i) for i in range(ahead)]
        if self.trace:
            # the profiler's first session sets itself up
            from torch.profiler import profile

            self.marker = torch.zeros(1, device=self.device)
            with profile(activities=self.activities()):
                self.marker.fill_(1.0).sum().item()
        self.say(f"segments {sizes}; warm batches done")

    def one_batch(self, strings: list[str]):
        """Parse and search one batch: (hits, t0, t_parsed, t1)."""
        import torch

        t0 = time.perf_counter()
        queries = [self.parser.parse_query(s) for s in strings]
        tp = time.perf_counter()
        hits = self.executor.search_batch(queries, self.traffic.k)
        if self.device == "cuda":
            torch.cuda.synchronize()
        return hits, t0, tp, time.perf_counter()

    # -- the window ----------------------------------------------------

    def window(self) -> None:
        self.answers: list[tuple[str, list]] = []
        self.failed = 0
        self.attempted = 0
        self.batches: list[dict] = []
        ex = self.executor
        host0 = sum(ex.fallbacks.values()), ex.host_routed
        reasons0 = dict(ex.fallbacks)
        start = time.perf_counter()
        i = 0
        while time.perf_counter() - start < self.seconds:
            strings = (self.log[i] if i < len(self.log)
                       else self.traffic.batch_at(i))
            i += 1
            self.attempted += len(strings)
            try:
                if self.trace:
                    hits, rec = self.traced_batch(strings)
                else:
                    hits, t0, tp, t1 = self.one_batch(strings)
                    rec = dict(t0=t0, t1=t1, queries=len(strings),
                               parse_s=tp - t0)
            except Exception:  # a failed batch counts, and the loop goes on
                self.say(traceback.format_exc())
                self.failed += len(strings)
                continue
            self.batches.append(rec)
            self.answers.extend(zip(strings, hits))
        self.end = max([start] + [b["t1"] for b in self.batches])
        self.start = start
        host1 = sum(ex.fallbacks.values()), ex.host_routed
        self.host_reasons = {k: v - reasons0.get(k, 0)
                             for k, v in ex.fallbacks.items()
                             if v != reasons0.get(k, 0)}
        done = sum(b["queries"] for b in self.batches)
        self.plans = done * self.n_segments
        self.host_plans = ((host1[0] - host0[0])
                           + (host1[1] - host0[1]) * self.n_segments)

    def activities(self) -> list:
        """The profiler's device activity only (its CPU activity would
        record every torch call of the planner); on the CPU, its CPU
        activity, which gives no device trace."""
        from torch.profiler import ProfilerActivity

        if self.device == "cuda":
            return [ProfilerActivity.CUDA]
        return [ProfilerActivity.CPU]

    def traced_batch(self, strings: list[str]):
        """One batch with the host spans, the profiler and the launch log
        on: (hits, the batch's trace record)."""
        import torch
        from torch.autograd import DeviceType
        from torch.profiler import profile

        from tantivy_tpu_torch.utils.trace import tracer

        acts = self.activities()
        ex = self.executor
        ex.launch_log = []
        before = self.counters.read()
        tracer.clear()
        tracer.enable()
        try:
            with profile(activities=acts) as prof:
                if self.device == "cuda":
                    # a marker kernel that ends just before the batch
                    # starts ties the device's clock to the host's
                    self.marker.fill_(1.0)
                    torch.cuda.synchronize()
                hits, t0, tp, t1 = self.one_batch(strings)
            tracer.record("searchbench.parse", t0, tp - t0)
            events = tracer.events
        finally:
            tracer.disable()
        # the tracer's clock: its events' `ts` are microseconds after a
        # fixed perf_counter time, which the parse span just recorded gives
        zero = t0 - events[-1]["ts"] / 1e6
        spans = [(e["name"], zero + e["ts"] / 1e6,
                  zero + (e["ts"] + e["dur"]) / 1e6) for e in events]
        after = self.counters.read()
        launches = {k: after[k] - before[k] for k in after
                    if after[k] != before[k]}
        n_bytes: dict[str, int] = {}
        for r in ex.launch_log:
            for k, v in launch_bytes(r).items():
                n_bytes[k] = n_bytes.get(k, 0) + v
        ex.launch_log = None
        device = None
        if self.device == "cuda":
            evs = sorted((e for e in prof.events()
                          if e.device_type == DeviceType.CUDA),
                         key=lambda e: e.time_range.start)
            if evs:
                shift = t0 - evs[0].time_range.end / 1e6
                device = [(e.name, shift + e.time_range.start / 1e6,
                           shift + e.time_range.end / 1e6) for e in evs[1:]]
                if not self.batches:
                    names: dict[str, int] = {}
                    for name, _, _ in device:
                        key = tracebook.function_name(name)
                        names[key] = names.get(key, 0) + 1
                    self.say(f"device operations of the first traced batch "
                             f"(marker: {evs[0].name[:60]}): {names}")
        seen: dict[str, int] = {}
        for name, _, _ in device or ():
            k = self.functions.get(tracebook.function_name(name))
            if k:
                seen[k] = seen.get(k, 0) + 1
        rec = dict(t0=t0, t1=t1, queries=len(strings), parse_s=tp - t0,
                   spans=spans, device=device, launches=launches,
                   seen=seen, complete=seen == launches, bytes=n_bytes)
        return hits, rec

    # -- the check -----------------------------------------------------

    def sample(self) -> list[int]:
        n = self.cell.mix.get("check_sample", 64)
        rng = rng_for(self.seed, 3)
        return sorted(rng.permutation(len(self.answers))[:n].tolist())

    def check(self, arith: Arith | None = None) -> dict:
        """The sampled answers of the window against the reference: the
        compared numbers, each with its limit."""
        ref = Reference(self.corpus, arith)
        k = self.traffic.k
        picked = self.sample()
        differing = 0
        for i in picked:
            query, hits = self.answers[i]
            got = [(int(np.float32(s).view(np.int32)), a.segment_ord,
                    a.doc_id) for s, a in hits]
            want = ref.topk(query, k)
            differing += sum(g != w for g, w in zip(got, want))
            differing += abs(len(got) - len(want))
        need = self.cell.mix.get("check_sample", 64)
        return {
            "hits_differing": {"value": differing, "max": 0},
            "queries_failed": {"value": self.failed, "max": 0},
            "queries_compared": {"value": len(picked), "min": need},
        }

    # -- the result ----------------------------------------------------

    def trace_record(self) -> dict:
        return dict(batches=self.batches, plans=self.plans,
                    host_plans=self.host_plans, kernels=self.functions,
                    hbm_bytes_per_s=self.peak.get("hbm_bytes_per_s"))

    def metrics(self) -> tuple[dict, dict, dict | None]:
        """(metrics, device extras, breakdown) of the run's kind."""
        if not self.trace:
            done = sum(b["queries"] for b in self.batches)
            span = self.end - self.start
            values = {"qps": done / span if span > 0 else None,
                      "setup_s": self.setup_s}
            out = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in self.cell.end_to_end
                   if values.get(m["name"]) is not None}
            return out, {}, None
        trace = self.trace_record()
        out = {}
        for m in self.cell.per_layer:
            mod = specs.reader(m["name"])
            v = mod.read(trace)
            if v is not None:
                out[m["name"]] = {"value": float(v), "unit": m["unit"]}
                note = getattr(mod, "note", None)
                self.say(f"{m['name']}: {v} {m['unit']}"
                         + (f" ({note(trace)})" if note else ""))
        whole = tracebook.complete(trace)
        dropped = len(self.batches) - len(whole)
        self.say(f"profiler: {len(whole)} of {len(self.batches)} traced "
                 f"batches whole; launches seen/counted by kernel: "
                 + "; ".join(f"{b['seen']}/{b['launches']}"
                             for b in self.batches[:3])
                 + (f" ... ({dropped} left out)" if dropped else ""))
        extra = {}
        if whole:
            extra = {"busy_s": sum(tracebook.length(tracebook.busy(b))
                                   for b in whole),
                     "window_s": sum(b["t1"] - b["t0"] for b in whole)}
        return out, extra, tracebook.breakdown(trace)

    def execute(self, out=sys.stdout) -> int:
        import torch

        if self.device == "cuda":
            if not torch.cuda.is_available():
                self.say("no CUDA device: the benchmark runs on the card only")
                return 2
            if torch.cuda.device_count() < self.cell.chips:
                self.say(f"{torch.cuda.device_count()} CUDA devices; the "
                         f"cell needs {self.cell.chips}")
                return 2
            self.kind = torch.cuda.get_device_name(0)
            peaks = specs.load_json(os.path.join(specs.BENCH_DIR,
                                                 "peaks.json"))
            if self.kind not in peaks:
                self.say(f"no peaks for {self.kind!r} in peaks.json: the "
                         f"rooflines need the card's own")
                return 2
            self.peak = peaks[self.kind]
        else:
            # the plain versions give no device trace, so no roofline
            self.kind, self.peak = "cpu", {}
        zstd_codec()
        self.setup()
        self.setup_s = process_age()
        self.say(f"setup_s {self.setup_s:.3f}")
        self.window()
        walls = sorted(round((b["t1"] - b["t0"]) * 1e3, 1)
                       for b in self.batches)
        self.say(f"window: {len(self.batches)} batches, "
                 f"{sum(b['queries'] for b in self.batches)} queries in "
                 f"{self.end - self.start:.3f} s; batch ms min "
                 f"{walls[0] if walls else None}, median "
                 f"{walls[len(walls) // 2] if walls else None}, max "
                 f"{walls[-1] if walls else None}; host-engine plans "
                 f"{self.host_plans} of {self.plans} "
                 f"({self.host_reasons}, {self.executor.host_routed} routed)")
        peak = (torch.cuda.max_memory_allocated() if self.device == "cuda"
                else 0)
        found = forbidden_modules()
        if found:
            self.say(f"modules loaded that the benchmark may not load: "
                     f"{found}")
            return 3
        metrics, extra, breakdown = self.metrics()
        del self.executor, self.searcher, self.index
        gc.collect()
        if self.device == "cuda":
            torch.cuda.empty_cache()
        t = time.perf_counter()
        checks = self.check()
        self.say(f"reference check: {time.perf_counter() - t:.1f} s")
        correct = (
            checks["hits_differing"]["value"] <= 0
            and checks["queries_failed"]["value"] <= 0
            and checks["queries_compared"]["value"]
            >= checks["queries_compared"]["min"])
        result = {
            "correct": correct,
            "attempted": self.attempted,
            "failed": self.failed,
            "metrics": metrics,
            "device": {"platform": "gpu" if self.device == "cuda" else "cpu",
                       "kind": self.kind, "count": self.cell.chips,
                       "memory_peak_bytes": int(peak), **extra},
        }
        if breakdown:
            result["breakdown"] = breakdown
        result["checks"] = checks
        for name, c in checks.items():
            lim = (f"<= {c['max']}" if "max" in c else f">= {c['min']}")
            self.say(f"check {name}: {c['value']} (limit {lim})")
        print(json.dumps(result), file=out, flush=True)
        return 0
