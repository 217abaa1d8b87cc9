"""tantivy_tpu_torch — the search engine on PyTorch and CUDA (NVIDIA Hopper).

The package stands alone: its host layers (schema, tokenizer, indexer,
directory, store, termdict, postings, fieldnorm, fastfield, query,
collector, aggregation, snippet, searcher) are its own modules, copies of
`tantivy_tpu`'s with the same on-disk format, so an index written by either
package is read by the other. This module exports the same public names as
`tantivy_tpu`, each from this package's own modules. The device path is the
port's: `BatchExecutor` runs term, boolean(term), phrase and phrase-prefix
batches through hand-written CUDA kernels (`csrc/group_probe.cu`,
`csrc/phrase_probe.cu`, and `csrc/bool_probe.cu` on the per-segment
`search_boolean_batch` path) and torch merge tails. It imports neither jax
nor `tantivy_tpu`.
"""

from .schema import (  # noqa: F401
    FAST,
    INDEXED,
    STORED,
    STORED_TEXT,
    STRING,
    TEXT,
    Document,
    FieldType,
    IndexRecordOption,
    NumericOptions,
    Schema,
    SchemaBuilder,
    Term,
    TextOptions,
)
from .index import Index, IndexReader, IndexSettings, ReloadPolicy, Warmer  # noqa: F401
from .indexer import IndexWriter, PreparedCommit  # noqa: F401
from .indexer.merge_policy import LogMergePolicy, MergePolicy, NoMergePolicy  # noqa: F401
from .searcher import DocAddress, Searcher  # noqa: F401
from .collector import (  # noqa: F401
    Collector,
    Count,
    DocSetCollector,
    FilterCollector,
    HistogramCollector,
    MultiCollector,
    TopDocs,
)
from .collector.sort_key import (  # noqa: F401
    SortByCallable,
    SortByFastField,
    SortByScore,
)
from .query import (  # noqa: F401
    AllQuery,
    BooleanQuery,
    BoostQuery,
    ConstScoreQuery,
    DisjunctionMaxQuery,
    EmptyQuery,
    ExistsQuery,
    FuzzyTermQuery,
    MoreLikeThisQuery,
    Occur,
    PhrasePrefixQuery,
    PhraseQuery,
    Query,
    RangeQuery,
    RegexQuery,
    TermQuery,
    TermSetQuery,
)
from .postings.format import TERMINATED  # noqa: F401
from .query.phrase_query import RegexPhraseQuery  # noqa: F401
from .query.explanation import DoesNotMatchError, Explanation  # noqa: F401
from .query.parser import QueryParser, QueryParserError  # noqa: F401
from .aggregation import AggregationCollector, AggregationLimits  # noqa: F401
from .collector.facet_collector import Facet, FacetCollector  # noqa: F401
from .snippet import Snippet, SnippetGenerator  # noqa: F401
from .executor import Executor  # noqa: F401
from .parallel import BatchExecutor  # noqa: F401

__version__ = "0.1.0"
