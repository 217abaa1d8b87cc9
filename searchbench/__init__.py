"""The benchmark of `tantivy_tpu_torch`: BM25 top-k query batches on one
card, driven by the data files beside this module (see `run.py`)."""
