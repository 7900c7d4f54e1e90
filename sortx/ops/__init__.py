"""Algorithm layer: parallel primitives (Tahoe/ParallelPrimitives analog)."""

from .extras import argsort, lexsort, sort_kv_u64, sort_u64
from .histogram import histogram
from .keyed import (is_sorted, partition, reduce_by_key,
                    run_length_encode, searchsorted, sum_by_key)
from .merge import merge, merge_kv
from .rows import sort_kv_rows, sort_rows
from .segmented import sort_kv_segments, sort_segments
from .segscan import scan_by_key, scan_segments
from .unique import unique
from .select import kth_value, median, top_k
from .scan import scan
from .sort import sort, sort_kv
from .out_of_core import (sort_large, sort_kv_large,
                          check_device_capacity, device_capacity_keys)
from .sort_xla import sort_xla, sort_kv_xla

__all__ = [
    "argsort",
    "sort_large",
    "sort_kv_large",
    "check_device_capacity",
    "device_capacity_keys",
    "lexsort",
    "sort_rows",
    "sort_kv_rows",
    "histogram",
    "is_sorted",
    "partition",
    "reduce_by_key",
    "run_length_encode",
    "searchsorted",
    "sum_by_key",
    "merge",
    "merge_kv",
    "sort_u64",
    "sort_kv_u64",
    "sort_segments",
    "sort_kv_segments",
    "kth_value",
    "median",
    "top_k",
    "scan",
    "scan_segments",
    "scan_by_key",
    "sort",
    "sort_kv",
    "sort_xla",
    "sort_kv_xla",
    "unique",
]
