"""tantivy_tpu_torch — the search engine's batched device path on PyTorch
and CUDA (NVIDIA Hopper).

The host layers (schema, tokenizer, indexer, directory, termdict, postings,
query, collector, searcher) are `tantivy_tpu`'s own and are re-exported
here unchanged; an index built by either package is read by both. This
package owns only the device path: `BatchExecutor` runs term, boolean(term),
phrase and phrase-prefix batches through hand-written CUDA kernels
(`csrc/group_probe.cu`, `csrc/phrase_probe.cu`, and `csrc/bool_probe.cu`
on the per-segment `search_boolean_batch` path) and torch merge tails. It
imports no jax.
"""

from tantivy_tpu import (  # noqa: F401
    FAST,
    INDEXED,
    STORED,
    STORED_TEXT,
    STRING,
    TERMINATED,
    TEXT,
    AggregationCollector,
    AggregationLimits,
    AllQuery,
    BooleanQuery,
    BoostQuery,
    Collector,
    ConstScoreQuery,
    Count,
    DisjunctionMaxQuery,
    DocAddress,
    DocSetCollector,
    Document,
    DoesNotMatchError,
    EmptyQuery,
    ExistsQuery,
    Executor,
    Explanation,
    Facet,
    FacetCollector,
    FieldType,
    FilterCollector,
    FuzzyTermQuery,
    HistogramCollector,
    Index,
    IndexReader,
    IndexRecordOption,
    IndexSettings,
    IndexWriter,
    LogMergePolicy,
    MergePolicy,
    MoreLikeThisQuery,
    MultiCollector,
    NoMergePolicy,
    NumericOptions,
    Occur,
    PhrasePrefixQuery,
    PhraseQuery,
    PreparedCommit,
    Query,
    QueryParser,
    QueryParserError,
    RangeQuery,
    RegexPhraseQuery,
    RegexQuery,
    ReloadPolicy,
    Schema,
    SchemaBuilder,
    Searcher,
    Snippet,
    SnippetGenerator,
    SortByCallable,
    SortByFastField,
    SortByScore,
    Term,
    TermQuery,
    TermSetQuery,
    TextOptions,
    TopDocs,
    Warmer,
)

from .parallel import BatchExecutor  # noqa: F401

__version__ = "0.1.0"
