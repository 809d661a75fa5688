"""bloomsearch-tpu on PyTorch and CUDA: a keyword-search engine over JSON rows.

The PyTorch port of the ``bloomsearch_tpu`` package: hierarchical bloom-filter
indexing (field / token / field:token keyspaces at file and block
granularity), partition + minmax prefilters, immutable single-pass data files
with atomic metadata updates, merge/compaction, and exact (re-verified)
streaming query results. The block-filter probe runs over device-resident
filter superbanks with a hand-written CUDA kernel (``kernels/probe.py``);
files are format-identical to the JAX package's.
"""

from .minmax import MinMaxIndex, convert_to_min_max_int64, convert_to_int64, update_min_max_index
from .tokenizer import (
    DEFAULT_DELIMITER,
    basic_whitespace_lower_tokenizer,
    compile_regex_query,
    make_field_token_key,
    row_has_field,
    row_has_field_token,
    row_matches_query,
    row_has_token,
    unique_fields,
)
from .query import (
    BloomCondition,
    BloomConditionType,
    BloomExpression,
    BloomExprType,
    BloomQuery,
    NumericCondition,
    Operator,
    PrefilterExpression,
    Query,
    QueryBuilder,
    QueryPrefilter,
    RegexExpression,
    RegexQuery,
    StringCondition,
    and_,
    and_bloom_queries,
    evaluate_data_block_metadata,
    evaluate_min_max_condition,
    evaluate_numeric_condition,
    evaluate_string_condition,
    field,
    field_regex,
    field_token,
    filter_data_blocks,
    min_max,
    new_query,
    numeric_between,
    numeric_equals,
    numeric_greater_than,
    numeric_greater_than_equal,
    numeric_in,
    numeric_less_than,
    numeric_less_than_equal,
    numeric_not_between,
    numeric_not_equals,
    numeric_not_in,
    or_,
    partition,
    partition_between,
    partition_equals,
    partition_greater_than,
    partition_greater_than_equal,
    partition_in,
    partition_less_than,
    partition_less_than_equal,
    partition_not_between,
    partition_not_equals,
    partition_not_in,
    prefilter_and,
    prefilter_or,
    regex_and,
    regex_field_guard_bloom_query,
    regex_or,
    token,
)
from .bloom import BloomFilter, BloomParams, estimate_parameters
from .compression import (
    COMPRESSION_NONE,
    COMPRESSION_SNAPPY,
    COMPRESSION_ZSTD,
    compression_available,
)
from .file_format import BloomFilters, DataBlockMetadata, FileMetadata
from .stores import (
    DataStore,
    DeleteOperation,
    FileSystemDataStore,
    MaybeFile,
    MemoryMetaStore,
    MetaStore,
    NullDataStore,
    NullMetaStore,
    WriteOperation,
    new_simple_meta_store,
)
from .engine import (
    BlockStats,
    BloomSearchEngine,
    BloomSearchEngineConfig,
    InvalidConfigError,
    MergeStats,
    StaleFileAssignmentError,
    default_config,
    prefilter_expiry,
)
from .utils import format_bytes_per_second, format_rate

__version__ = "0.3.0"
