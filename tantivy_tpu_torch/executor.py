"""Search executor — per-segment fan-out (reference `src/core/executor.rs`).

`SingleThread` runs inline; `ThreadPool` maps segments across a
ThreadPoolExecutor (numpy releases the GIL in the hot kernels, and device
dispatch overlaps). Results keep segment order, like the reference's
order-preserving `Executor::map`.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor


class Executor:
    def __init__(self, pool: ThreadPoolExecutor | None = None):
        self._pool = pool

    @classmethod
    def single_thread(cls) -> "Executor":
        return cls(None)

    @classmethod
    def multi_thread(
        cls, num_threads: int, name_prefix: str = "tantivy-search-"
    ) -> "Executor":
        return cls(ThreadPoolExecutor(num_threads, thread_name_prefix=name_prefix))

    def map(self, fn, items):
        items = list(items)
        if self._pool is None or len(items) <= 1:
            return [fn(item) for item in items]
        return list(self._pool.map(fn, items))
