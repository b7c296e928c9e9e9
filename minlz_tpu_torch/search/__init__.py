"""Compressed-stream search: per-block bloom tables (SPEC_SEARCH.md).

Covers table types 1-4, uncompressed (0x45) and huff0-compressed (0x46)
table chunks with up to 16 shared tables, reductions, boundary-overlap
indexing, deferred decode, sidecar build/extract/search (0x47),
reference-class SearchStats with per-window presence counts, and the
forward-context protocol (callback returns SEARCH_FORWARD for more
context).  BlockSearcher keeps the no-false-negatives invariant.
"""

from .table import SearchTableConfig, hash_value
from .build import build_table, build_table_auto, build_tables_device
from .searcher import (
    SEARCH_FORWARD,
    BlockSearcher,
    SearchResult,
    SearchStats,
    WindowStat,
)

__all__ = [
    "SEARCH_FORWARD",
    "SearchTableConfig",
    "hash_value",
    "build_table",
    "build_table_auto",
    "build_tables_device",
    "BlockSearcher",
    "SearchResult",
    "SearchStats",
    "WindowStat",
]
