"""Host runtime: the C++ loader, workload parser and result formatter
(counterpart: radixhashjoin_tpu/runtime/).

The reference's host substrate is C++ (mmap loader structs.cpp:17-63,
char-level parser Query.cpp:10-63, result printer Query.cpp:226-235).
native/rhj_host.cpp is the port's copy of the JAX package's library:
built at first use (runtime/native.py), bound with ctypes, giving the
relations, stats, queries and lines of storage.py, workload.py and
oracle.format_result.
"""

from .native import (format_results_native, load_relation_native,
                     parse_work_native)

__all__ = ["load_relation_native", "parse_work_native",
           "format_results_native"]
