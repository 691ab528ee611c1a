"""The port's DeviceCatalog (radixhashjoin_tpu_torch/models/device_catalog.py)
serves exactly the JAX catalog's arrays for the same relations: join
codes, projection planes, composite edge keys, precomputed bincount
tables, and the host-side scalars the planner reads. Narrow (identity)
and wide (u64 dictionary) catalogs; integer equality, tolerance 0. Each
package builds from its own Relation objects over the same columns.
"""

import numpy as np
import pytest
import torch

from radixhashjoin_tpu.config import EngineConfig as JaxConfig
from radixhashjoin_tpu.models.device_catalog import (
    DeviceCatalog as JaxCatalog)
from radixhashjoin_tpu.storage import Relation
from radixhashjoin_tpu_torch import storage as tstorage
from radixhashjoin_tpu_torch.config import EngineConfig
from radixhashjoin_tpu_torch.models.device_catalog import DeviceCatalog

torch.set_num_threads(1)


def _narrow(rng):
    return [Relation([rng.integers(0, vmax, n).astype(np.uint64)
                      for vmax in (64, 1 << 12, 1 << 16)])
            for n in (1, 200, 333)]


def _wide(rng):
    pool = rng.integers(0, 2**63, 40, dtype=np.uint64)
    pool[:4] = [0, 1, 2**32, 2**64 - 1]
    rels = [Relation([rng.choice(pool, n),
                      rng.integers(0, 50, n).astype(np.uint64) << np.uint64(
                          40),
                      rng.integers(0, 2**31 - 1, n).astype(np.uint64)])
            for n in (150, 77)]
    rels.append(Relation([rng.integers(0, 9, 60).astype(np.uint64),
                          rng.integers(0, 9, 60).astype(np.uint64)]))
    return rels


def _both(rels):
    """(port catalog, JAX catalog) over the same columns."""
    ours = DeviceCatalog([tstorage.Relation(list(r.values)) for r in rels],
                         EngineConfig(), device="cpu")
    return ours, JaxCatalog(rels, JaxConfig())


def _same(a, b):
    a = a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    assert a.dtype == np.int32 and b.dtype == np.int32, (a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kind", ["narrow", "wide"])
def test_catalog_arrays_match_jax(kind):
    rng = np.random.default_rng(17 if kind == "narrow" else 18)
    rels = _narrow(rng) if kind == "narrow" else _wide(rng)
    ours, ref = _both(rels)
    assert (ours.dict_vals is None) == (kind == "narrow")
    if ours.dict_vals is not None:
        np.testing.assert_array_equal(ours.dict_vals, ref.dict_vals)
    assert ours.domain == ref.domain
    for r, rel in enumerate(rels):
        for c in range(rel.num_columns):
            _same(ours.col(r, c), ref.col(r, c))
            assert ours.code_max(r, c) == ref.code_max(r, c)
            assert ours.max_mult(r, c) == ref.max_mult(r, c)
            assert ours.plane_maxes(r, c) == ref.plane_maxes(r, c)
            po, pr = ours.proj_planes(r, c), ref.proj_planes(r, c)
            assert [s for _p, s in po] == [s for _p, s in pr]
            for (a, _s), (b, _t) in zip(po, pr):
                _same(a, b)
            _same(ours.bincount_table(r, c), ref.bincount_table(r, c))
    assert ours.bucket(3000) == ref.bucket(3000)


@pytest.mark.parametrize("kind", ["narrow", "wide"])
def test_edge_keys_match_jax(kind):
    """Single and composite (2- and 3-column) tree-edge keys, their max
    multiplicities and the precomputed leaf bincounts."""
    rng = np.random.default_rng(5 if kind == "narrow" else 6)
    rels = _narrow(rng) if kind == "narrow" else _wide(rng)
    ours, ref = _both(rels)
    for pcols, ccols in (((0,), (1,)), ((0, 1), (1, 0)),
                         ((0, 1, 2), (2, 1, 0))):
        for rp, rc in ((1, 2), (2, 1), (1, 1)):
            if (max(pcols) >= rels[rp].num_columns
                    or max(ccols) >= rels[rc].num_columns):
                continue
            pk, ck, cm = ours.edge_key(rp, pcols, rc, ccols)
            jpk, jck, jcm = ref.edge_key(rp, pcols, rc, ccols)
            _same(pk, jpk)
            _same(ck, jck)
            assert cm == jcm
            for side in "pc":
                assert (ours.edge_key_max_mult(rp, pcols, rc, ccols, side)
                        == ref.edge_key_max_mult(rp, pcols, rc, ccols, side))
            if len(pcols) > 1:
                w = 1 << max(3, (cm + 1).bit_length())
                _same(ours.edge_bincount(rp, pcols, rc, ccols, w),
                      ref.edge_bincount(rp, pcols, rc, ccols, w))


@pytest.mark.parametrize("op,value", [
    ("=", 5), ("=", 7), ("<", 10), ("<", 11), (">", 9), (">", 10),
    (">", 2**63 - 1), ("<", 2**64 - 1), ("=", 2**40), ("<", 0),
])
def test_encode_filter_matches_jax(op, value):
    vals = np.array([5, 10, 2**40, 2**63 - 1], dtype=np.uint64)
    for rels in ([Relation([vals])],
                 [Relation([np.array([5, 10, 3], np.uint64)])]):
        ours, ref = _both(rels)
        opc, const = ours.encode_filter(op, value)
        jopc, jconst = ref.encode_filter(op, value)
        assert (opc, const) == (jopc, int(jconst))


def test_identity_encoding_at_int32_edge():
    """Values up to NARROW_MAX keep the identity encoding (codes are the
    values, one int32 plane); one past it switches to the dictionary."""
    for top, wide in ((2**31 - 2, False), (2**31 - 1, True)):
        ours, ref = _both([Relation([np.array([0, 7, top], np.uint64)])])
        assert (ours.dict_vals is not None) == wide
        _same(ours.col(0, 0), ref.col(0, 0))
        assert ours.code_max(0, 0) == ref.code_max(0, 0)
        [(a, s)], [(b, t)] = ours.proj_planes(0, 0), ref.proj_planes(0, 0)
        assert s == t == 0
        _same(a, b)


def test_catalog_uploads_to_named_device_only():
    rels = [tstorage.Relation(list(r.values))
            for r in _narrow(np.random.default_rng(1))]
    cat = DeviceCatalog(rels, EngineConfig(), device="cpu")
    assert cat.col(1, 0).device.type == "cpu"
    # no device: the card, never a silent CPU
    if torch.cuda.is_available():
        assert DeviceCatalog(rels, EngineConfig()).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="--device cpu"):
            DeviceCatalog(rels, EngineConfig())
