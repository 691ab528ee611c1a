"""The port's distributed benches on the CPU: bench_dist_scale
(scripts/bench_dist_scale.py) and scale_efficiency
(scripts/scale_efficiency.py), each through its main(argv, out) on
spawned gloo ranks (or a world of one in this process), every line
exact (tolerance 0).

bench_dist_scale at 2^12 rows a rank on 2 ranks: the reference's metric
names in its order, each path's sums equal to the closed form on the
reference's data (drawn here again from default_rng(0)) and to JAX's
DistExecutor on a 2-device mesh, every byte and time field "not
measured"; --ftree-only in a world of one; --overfill on 2 ranks with the
huge-node thresholds shrunk below a rank's real rows (as
tests/test_torch_huge.py shrinks them), so each shard takes the windowed
pass. scale_efficiency --ns 1,2 --rows 12: one line per world, equal
sums, and the two efficiency lines.
"""

import io
import json
from dataclasses import astuple

import numpy as np
import pytest
import torch

from radixhashjoin_tpu.config import EngineConfig as JaxConfig
from radixhashjoin_tpu.parallel import DistExecutor as JaxDist
from radixhashjoin_tpu.storage import Relation as JaxRelation
from radixhashjoin_tpu.workload import (FilterPred, JoinPred, Projection,
                                        Query)
from radixhashjoin_tpu_torch import bench_dist_scale, bench_scale
from radixhashjoin_tpu_torch import scale_efficiency
from radixhashjoin_tpu_torch.parallel import multihost

import torch_dist_ranks

torch.set_num_threads(1)

ROWS = 12                       # log2 rows a rank
METRICS = ["dist_star_ftree_tuples_per_s", "dist_mem_d_ftree_star",
           "dist_exchange_join_tuples_per_s", "dist_mem_d_case1_probe",
           "dist_mem_d_case1_expand", "dist_mem_d_project_gcap",
           "dist_mem_d_project_worst_case"]
MEASURED = ("catalog_bytes_per_chip", "value", "seconds", "argument",
            "output", "peak_above_entry")


def _lines(out):
    return [json.loads(ln) for ln in out.getvalue().splitlines()]


def _main(mod, argv):
    out = io.StringIO()
    assert mod.main(list(argv) + ["--device", "cpu"], out) == 0
    return _lines(out)


def _cases(n):
    """The reference's two configs at n rows, in its draw order."""
    rng = np.random.default_rng(0)
    star = bench_scale.star(n, rng, bench_scale.N_KEYS)
    return star, bench_dist_scale.exchange(n, rng)


def _jax_line(case, cfg, n_devices):
    q = case.query
    jq = Query(q.slots, [JoinPred(*astuple(j)) for j in q.joins],
               [FilterPred(*astuple(f)) for f in q.filters],
               [Projection(*astuple(p)) for p in q.projections])
    ex = JaxDist([JaxRelation(r.values) for r in case.rels], cfg,
                 n_devices=n_devices)
    return ex.run_batch([jq])[0]


@pytest.fixture(scope="module")
def two_ranks():
    return _main(bench_dist_scale, ["--devices", "2", "--rows-per-chip",
                                    str(ROWS)])


def test_bench_dist_scale_metrics_and_cpu_fields(two_ranks):
    assert [ln["metric"] for ln in two_ranks] == METRICS
    for ln in two_ranks:
        assert ln.get("exact", True) is True
        for key in MEASURED:
            if key in ln:
                assert ln[key] == "not measured", (ln["metric"], key)
    star, exch = two_ranks[0], two_ranks[2]
    assert (star["devices"], star["backend"], star["fact_rows"]) == (
        2, "gloo", 2 << ROWS)
    assert exch["rows_per_side"] == 2 << ROWS
    assert two_ranks[5]["gcap"] == two_ranks[6]["gcap"] == 0


@pytest.mark.parametrize("config", ["star", "exchange"])
def test_bench_dist_scale_exact_and_equal_to_jax(two_ranks, config):
    """The line's sums are the closed form's and JAX's DistExecutor's on
    the same data (2 devices)."""
    star, exch = _cases(2 << ROWS)
    if config == "star":
        case, cfg, line = star, JaxConfig(), two_ranks[0]
    else:
        case, line = exch, two_ranks[2]
        cfg = JaxConfig(factorized=False, gather_chunks=1)
    assert line["sums"] == case.expected[0]
    assert _jax_line(case, cfg, 2) == case.expected[0]


def test_bench_dist_scale_ftree_only_world_of_one():
    lines = _main(bench_dist_scale, ["--devices", "1", "--ftree-only",
                                     "--rows-per-chip", str(ROWS)])
    assert [ln["metric"] for ln in lines] == METRICS[:2]
    star, _exch = _cases(1 << ROWS)
    assert lines[0]["sums"] == star.expected[0]
    assert lines[0]["devices"] == 1


def test_bench_dist_scale_overfill_huge_shards():
    """--overfill: 1.25 x 2^12 real rows a rank, past a huge-node
    threshold shrunk to 4096 rows (windows of 1024), on 2 ranks; the
    windowed pass runs on every rank and every line stays exact."""
    n = (2 << ROWS) * 5 // 4
    outs = multihost.run_ranks(
        torch_dist_ranks.dist_bench, 2,
        (["--rows-per-chip", str(ROWS), "--overfill"],
         {"big_wave_rows": 1 << ROWS, "big_window_rows": 1024}),
        device="cpu", timeout=300)
    star, exch = _cases(n)
    for lines, windowed in outs:
        assert [ln["metric"] for ln in lines] == METRICS
        assert lines[0]["fact_rows"] == n
        assert lines[0]["sums"] == star.expected[0]
        assert lines[2]["sums"] == exch.expected[0]
        assert windowed > 0


def test_scale_efficiency_worlds_of_one_and_two():
    lines = _main(scale_efficiency, ["--ns", "1,2", "--rows", str(ROWS)])
    per_n = [ln for ln in lines
             if ln["metric"] == "dist_engine_join_tuples_per_s"]
    eff = [ln for ln in lines if ln["metric"] == "scaling_efficiency"]
    assert [ln["devices"] for ln in per_n] == [1, 2]
    assert [ln["devices"] for ln in eff] == [1, 2]
    _rels, want = scale_efficiency.uniform_join(ROWS)
    for ln in per_n:
        assert ln["sums"] == want and ln["exact"] is True
        assert (ln["path"], ln["backend"], ln["ranks_per_card"]) == (
            "ftree", "gloo", None)
        assert ln["rows_per_side"] == 1 << ROWS
        assert ln["value"] == ln["seconds"] == "not measured"
    assert all(ln["value"] == "not measured" for ln in eff)
