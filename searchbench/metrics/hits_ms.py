"""Entry: the end of the batch, ms a batch: the time under the port's
`batch.hits` spans (each chain's sort, dedup and cut of its queries'
chunks, and `search_batch`'s answer loop) less the host engine's
`host.*` spans inside them. The fused chains freeing their plans just
before is `release_ms`."""

from searchbench import batch_spans as bs


def read(trace):
    return bs.ms_per_batch(
        trace, lambda b: bs.self_time(b, ("batch.hits",), ("host.",)))
