"""Card-only tests of the port: the hand-written CUDA kernels against
their plain PyTorch versions, and the engine on a CUDA device against
the port's oracle. Marked `cuda`; they skip without a card. They import
nothing of jax or of the JAX package, so they also run where jax is
absent:

    python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest
"""

import numpy as np
import pytest
import torch

from radixhashjoin_tpu_torch import kernels
from radixhashjoin_tpu_torch.config import EngineConfig
from radixhashjoin_tpu_torch.models.engine import Engine
from radixhashjoin_tpu_torch.oracle import OracleExecutor, format_result
from radixhashjoin_tpu_torch.ops.tables import (table_gather_torch,
                                                weighted_bincount_torch)
from radixhashjoin_tpu_torch.storage import Relation
from radixhashjoin_tpu_torch.workload import (FilterPred, JoinPred,
                                              Projection, Query)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("n,n_bins", [
    (1, 8), (5000, 700), (1 << 20, 1024), (1 << 20, 48 * 1024),
    (1 << 20, 48 * 1024 + 1), (1 << 22, 1 << 20)])
def test_bincount_kernel_exact(dev, n, n_bins):
    g = torch.Generator(device=dev).manual_seed(n + n_bins)
    idx = torch.randint(-2, n_bins + 2, (n,), generator=g, device=dev,
                        dtype=torch.int32)
    w = torch.randint(0, 1000, (n,), generator=g, device=dev,
                      dtype=torch.int32)
    before = kernels.LAUNCHES["bincount"]
    got = kernels.weighted_bincount_cuda(idx, w, n_bins)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["bincount"] == before + 1
    assert torch.equal(got, weighted_bincount_torch(idx, w, n_bins))


@pytest.mark.parametrize("n,n_bins", [(1, 8), (4097, 1000),
                                      (1 << 22, 1 << 20)])
def test_gather_kernel_exact(dev, n, n_bins):
    g = torch.Generator(device=dev).manual_seed(n)
    table = torch.randint(-2**31, 2**31 - 1, (n_bins,), generator=g,
                          device=dev, dtype=torch.int32)
    keys = torch.randint(-5, n_bins + 5, (n,), generator=g, device=dev,
                         dtype=torch.int32)
    got = kernels.table_gather_cuda(table, keys)
    torch.cuda.synchronize()
    assert torch.equal(got, table_gather_torch(table, keys))


def test_wrappers_reject_bad_operands(dev):
    x = torch.zeros(4, dtype=torch.int32, device=dev)
    with pytest.raises(TypeError):
        kernels.weighted_bincount_cuda(x.long(), x, 8)
    with pytest.raises(ValueError):
        kernels.table_gather_cuda(x, x[::2])
    assert kernels.weighted_bincount_cuda(x[:0], x[:0], 8).shape == (8,)


def _tree_workload(rng, n_rel=4, n_queries=8):
    """Random relations and tree-shaped queries (each join attaches a
    fresh slot), the shape of tests/test_factorized.py's generators."""
    rels = []
    for _ in range(n_rel):
        n = int(rng.integers(2, 300))
        rels.append(Relation([rng.integers(0, 64, n).astype(np.uint64)
                              for _ in range(3)]))
    queries = []
    for _ in range(n_queries):
        nslots = int(rng.integers(2, 5))
        slots = [int(rng.integers(0, n_rel)) for _ in range(nslots)]
        joins = [JoinPred(int(rng.integers(0, s)), int(rng.integers(0, 3)),
                          s, int(rng.integers(0, 3)))
                 for s in range(1, nslots)]
        filters = [FilterPred(int(rng.integers(0, nslots)),
                              int(rng.integers(0, 3)),
                              str(rng.choice(["=", "<", ">"])),
                              int(rng.integers(0, 70)))
                   for _ in range(int(rng.integers(0, 3)))]
        projs = [Projection(int(rng.integers(0, nslots)), 0)
                 for _ in range(int(rng.integers(1, 4)))]
        queries.append(Query(slots, joins, filters, projs))
    return rels, queries


@pytest.mark.parametrize("seed", range(3))
def test_engine_on_cuda_matches_oracle(dev, seed):
    rels, queries = _tree_workload(np.random.default_rng(200 + seed))
    before = dict(kernels.LAUNCHES)
    got = Engine(rels, EngineConfig(), device=dev).run_batch(queries)
    oracle = OracleExecutor(rels)
    assert got == [format_result(oracle.execute(q), len(q.projections))
                   for q in queries]
    assert all(kernels.LAUNCHES[k] > before[k] for k in before)
