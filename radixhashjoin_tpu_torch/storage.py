"""Columnar storage: relation loading and load-time statistics
(counterpart: radixhashjoin_tpu/storage.py).

The on-disk contract is the reference binary's (structs.cpp:17-63 of the
C++ engine): little-endian ``[num_tuples u64][num_columns u64]``, then
the columns back to back, each ``num_tuples`` uint64s; the file size must
equal ``(t*c + 2) * 8``. Columns are zero-copy ``np.memmap`` views on the
host. Per-column stats (min / max / exact distinct) drive the catalog's
encoding and the planner's caps. The distinct count sorts a column, as
the reference does, unless its values lie below max(rows, 2**20): then
one O(n) bincount gives the same numbers (`small_value_counts`), which
matters on the 2**29-row facts of the huge-node path.

The reference also has a C++ loader (runtime/native.py) with identical
results; the port loads with NumPy only (ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

INT32_MAX = 2**31 - 1

# a column whose values lie below max(rows, this) counts its values with
# one bincount instead of np.unique's sort
_BINCOUNT_MIN_RANGE = 1 << 20


def small_value_counts(col: np.ndarray, vmax: int) -> Optional[np.ndarray]:
    """np.bincount of a non-empty column whose largest value `vmax` lies
    below max(len(col), 2**20), else None (the caller sorts instead)."""
    if vmax >= max(len(col), _BINCOUNT_MIN_RANGE):
        return None
    return np.bincount(col.astype(np.intp))


@dataclasses.dataclass
class ColumnStats:
    """Per-column min/max/distinct (reference: relList_stats, structs.h:24-31)."""
    min: int
    max: int
    distinct: int


class Relation:
    """A loaded columnar relation.

    ``values[c]`` is a uint64 host view of column ``c`` (zero-copy memmap
    when loaded from file); ``narrow_column(c)`` is its cached int32 copy
    when every value fits.
    """

    def __init__(self, columns: List[np.ndarray], path: Optional[str] = None,
                 compute_stats: bool = True):
        assert len(columns) > 0
        n = len(columns[0])
        for col in columns:
            assert len(col) == n, "all columns must share num_tuples"
        self.path = path
        self.num_tuples = int(n)
        self.num_columns = len(columns)
        self.values: List[np.ndarray] = columns
        self.stats: List[ColumnStats] = []
        self._narrow: List[Optional[np.ndarray]] = [None] * self.num_columns
        if compute_stats:
            self._fill_stats()

    def _fill_stats(self) -> None:
        for col in self.values:
            if len(col) == 0:
                self.stats.append(ColumnStats(0, 0, 0))
                continue
            vmax = int(col.max())
            counts = small_value_counts(col, vmax)
            if counts is None:
                self.stats.append(ColumnStats(int(col.min()), vmax,
                                              int(len(np.unique(col)))))
                continue
            nz = np.flatnonzero(counts)
            self.stats.append(ColumnStats(int(nz[0]), vmax, len(nz)))

    def set_stats(self, stats: List[ColumnStats]) -> None:
        self.stats = stats

    def narrow_column(self, c: int) -> np.ndarray:
        """int32 copy of column c (cached); the column must fit int32."""
        if self._narrow[c] is None:
            assert self.stats[c].max <= INT32_MAX, (
                f"column {c} has values >= 2**31; use the dictionary")
            self._narrow[c] = self.values[c].astype(np.int32)
        return self._narrow[c]


def load_relation(path: str, compute_stats: bool = True) -> Relation:
    """mmap a binary relation file (reference: relList ctor, structs.cpp:17-39)."""
    raw = np.memmap(path, dtype="<u8", mode="r")
    assert raw.size >= 2, f"{path}: truncated header"
    num_tuples = int(raw[0])
    num_columns = int(raw[1])
    assert raw.size == num_tuples * num_columns + 2, (
        f"{path}: size mismatch (structs.cpp:30 contract)")
    body = raw[2:]
    cols = [body[c * num_tuples:(c + 1) * num_tuples]
            for c in range(num_columns)]
    return Relation(cols, path=path, compute_stats=compute_stats)


def write_relation(path: str, columns: List[np.ndarray]) -> None:
    """Write a relation in the reference binary format."""
    n = len(columns[0])
    with open(path, "wb") as f:
        f.write(np.array([n, len(columns)], dtype="<u8").tobytes())
        for col in columns:
            f.write(np.ascontiguousarray(col, dtype="<u8").tobytes())
