"""radixhashjoin_tpu_torch — the PyTorch + CUDA port of radixhashjoin_tpu.

The same engine (SIGMOD-2018-contest stream protocol: uint64 columnar
relations, filters, equi-join pipelines, exact u64 SUM projections),
written in PyTorch for an NVIDIA H100 with hand-written Hopper kernels
for the message-table build and lookup. `radixhashjoin_tpu` stays the
reference: every module here names its counterpart there, and the tests
hold both packages to identical results on the same inputs.

Slices covered so far: the wave-batched path, which answers every query
shape of a batch. Tree-shaped queries plan on the host (models/batch.py)
and run as ONE level-batched message-passing wave (ops/factorized.py);
the rest run as materialized stage ops of the same round (ops/stage.py)
or, on the sort backend, through the per-op path. The build and lookup
kernels live in csrc/tables.cu, and SUMs fold exactly in int64
(utils/limbs.py). The radix kernels of csrc/radix.cu and the
distributed layer (parallel/) are ported too. The JAX package's
per-query executor and its XLA table variants are not: the batch path
answers every query, and the hand kernels beat every variant on the
card.
The per-op paths' filters run as one conjunctive select kernel a
filtered slot (csrc/select.cu, ops/filter.py filter_conj).

This package imports neither jax nor radixhashjoin_tpu: its host
modules (config, storage, workload, oracle) are its own, each naming
its counterpart.

Layout:
  config, storage, workload, oracle — host side: settings, relation
             files, stream parsing, the NumPy oracle and line format
  models   — Engine facade, batch executor + host planners, catalog
  ops      — factorized wave, fused stage runner, joins, table
             build/lookup
  utils    — padding policy, exact int64 folds
  kernels  — nvcc build + ctypes binding of csrc/*.cu
"""

from .config import EngineConfig
from .models.engine import Engine

__all__ = ["Engine", "EngineConfig"]
