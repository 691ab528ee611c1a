"""Join backend: dense direct-address vs sort (counterpart:
radixhashjoin_tpu/ops/backend.py).

Both backends share the (order, lo, offsets, cum, total) probe contract
and the (left index, right index) expansion contract; the batch executor
picks one per engine from the catalog's value domain:

  dense — bounded key domain (ops/join_dense.py): the build and lookup
          kernels of csrc/tables.cu on a CUDA tensor;
  sort  — domain-oblivious (ops/join.py): a stable torch.sort of the
          right side and, on a CUDA tensor, the probe kernel of
          csrc/probe.cu (probe_gather_count, which gathers the left side
          itself).

The wrappers also gather the inputs (rowids -> values). The reference's
dense expansion is its sort expansion line for line in the port
(join_dense.dense_expand is join.expand_pairs), so both backends share
one pair of expansion wrappers.
"""

from __future__ import annotations

import torch

from .filter import gather_clamped as _g
from .join import any_common, expand_pairs, probe_gather_count
from .join_dense import dense_any_common, dense_probe


# ---- dense-backend wrappers ----

def _probe_rows_dense(col_l, lrows, lcount, col_r, rrows, rcount,
                      domain: int):
    return dense_probe(_g(col_l, lrows), lcount, _g(col_r, rrows), rcount,
                       domain)


def _probe_matrix_dense(col_l, mat, lrow: int, lcount, col_r, rrows, rcount,
                        domain: int):
    return dense_probe(_g(col_l, mat[lrow]), lcount, _g(col_r, rrows),
                       rcount, domain)


def _any_common_matrix_dense(colA, colB, mat, i1: int, i2: int, count,
                             domain: int):
    return dense_any_common(_g(colA, mat[i1]), _g(colB, mat[i2]), count,
                            domain)


# ---- sort-backend wrappers ----

def _probe_rows_sort(col_l, lrows, lcount, col_r, rrows, rcount):
    return probe_gather_count(col_l, lrows, lcount, col_r, rrows, rcount)


def _probe_matrix_sort(col_l, mat, lrow: int, lcount, col_r, rrows, rcount):
    return probe_gather_count(col_l, mat[lrow], lcount, col_r, rrows,
                              rcount)


def _any_common_matrix_sort(colA, colB, mat, i1: int, i2: int, count):
    return any_common(_g(colA, mat[i1]), _g(colB, mat[i2]), count)


# ---- expansions (both backends) ----

def _expand_pair(order, lo, off, cum, lrows, rrows, out_size: int
                 ) -> torch.Tensor:
    """Case 1: the (2, out_size) matrix of matched rowid pairs."""
    li, ri = expand_pairs(order, lo, off, cum, out_size)
    return torch.stack([_g(lrows, li), _g(rrows, ri)])


def _expand_attach(order, lo, off, cum, mat, fresh_rows, out_size: int
                   ) -> torch.Tensor:
    """Case 2: every matrix column replicated per match, the fresh
    slot's rowids appended as a new last row."""
    li, ri = expand_pairs(order, lo, off, cum, out_size)
    return torch.cat([mat.index_select(1, li), _g(fresh_rows, ri)[None]])


class JoinBackend:
    """Uniform interface over the two join formulations."""

    def __init__(self, kind: str, domain: int = 0):
        if kind not in ("dense", "sort"):
            raise ValueError(f"unknown join backend {kind!r}")
        self.kind = kind
        self.domain = domain

    def probe_rows(self, col_l, lrows, lcount, col_r, rrows, rcount):
        if self.kind == "dense":
            return _probe_rows_dense(col_l, lrows, lcount, col_r, rrows,
                                     rcount, self.domain)
        return _probe_rows_sort(col_l, lrows, lcount, col_r, rrows, rcount)

    def probe_matrix(self, col_l, mat, lrow, lcount, col_r, rrows, rcount):
        if self.kind == "dense":
            return _probe_matrix_dense(col_l, mat, lrow, lcount, col_r,
                                       rrows, rcount, self.domain)
        return _probe_matrix_sort(col_l, mat, lrow, lcount, col_r, rrows,
                                  rcount)

    def expand_fresh_pair(self, order, lo, off, cum, lrows, rrows,
                          out_size):
        return _expand_pair(order, lo, off, cum, lrows, rrows, out_size)

    def expand_attach_fresh(self, order, lo, off, cum, mat, fresh_rows,
                            out_size):
        return _expand_attach(order, lo, off, cum, mat, fresh_rows,
                              out_size)

    def any_common_matrix(self, colA, colB, mat, i1, i2, count):
        if self.kind == "dense":
            return _any_common_matrix_dense(colA, colB, mat, i1, i2, count,
                                            self.domain)
        return _any_common_matrix_sort(colA, colB, mat, i1, i2, count)
