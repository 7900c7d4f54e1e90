"""sortx — a parallel sort/scan framework in JAX.

A from-scratch JAX re-imagination of the capability set of
takahiroharada/OCLRadixSort (an AMD-GPU OpenCL radix sort library):
exclusive prefix scan, stable LSD radix sort of 32-bit keys and key-value
pairs — built on XLA's sort and scan, one Pallas kernel where it was
measured faster, and multi-device meshes (new scope the reference never
had).

Layer map (SURVEY.md §1 mapping):
  Tahoe/ParallelPrimitives -> sortx.ops        (scan/sort primitives)
  Adl device layer         -> sortx.runtime    (device/buffer/launcher/...)
  (absent in reference)    -> sortx.parallel   (multi-chip distributed sort)
  UnitTest                 -> tests/           (pytest vs the golden oracle)
"""

from .api import ParallelPrimitives
from .config import Config, default_config, set_default_config
from .ops import (argsort, histogram, is_sorted, kth_value, lexsort,
                  median, merge,
                  merge_kv, partition, reduce_by_key, run_length_encode,
                  scan, scan_by_key, scan_segments, searchsorted, sort, sort_kv,
                  sort_kv_rows, sort_kv_segments, sort_kv_u64, sort_rows,
                  sort_kv_large, sort_large,
                  sort_segments, sort_u64, sum_by_key, top_k, unique)
from .parallel import (dist_scan, dist_sort, dist_sort_kv,
                       dist_sort_kv_padded, dist_sort_padded,
                       make_sort_mesh)
from . import parallel
from . import reference
from . import runtime
from . import utils

__version__ = "0.1.0"

__all__ = [
    "ParallelPrimitives",
    "Config",
    "default_config",
    "set_default_config",
    "argsort",
    "lexsort",
    "histogram",
    "merge",
    "merge_kv",
    "scan",
    "scan_segments",
    "scan_by_key",
    "sort",
    "sort_kv",
    "sort_large",
    "sort_kv_large",
    "sort_rows",
    "sort_kv_rows",
    "sort_u64",
    "sort_kv_u64",
    "sort_segments",
    "sort_kv_segments",
    "kth_value",
    "median",
    "top_k",
    "unique",
    "partition",
    "reduce_by_key",
    "sum_by_key",
    "run_length_encode",
    "searchsorted",
    "is_sorted",
    "dist_scan",
    "dist_sort",
    "dist_sort_kv",
    "dist_sort_padded",
    "dist_sort_kv_padded",
    "make_sort_mesh",
    "parallel",
    "reference",
    "runtime",
    "utils",
    "__version__",
]
