"""The port's bench entry points (radixhashjoin_tpu_torch/bench_scale.py,
bench.py, bench_planner.py, bench_microops.py) against the JAX package,
the port's oracle and their own closed forms, on the CPU.

* Every bench_scale engine config at 2^12-2^14 rows: its closed-form
  lines equal the port's OracleExecutor's, the port Engine's and the JAX
  Engine's on the same NumPy columns. The two-deep chain, and the Zipf
  join and big star as phase 4b runs them, also run with both packages'
  huge-node thresholds shrunk alike (as tests/test_torch_huge.py does),
  so that every fact takes the windowed pass with a ragged last window.
* The dense-probe configs: the port's dense_probe tuple element-equal to
  JAX's ops/join_dense.dense_probe on the same keys, and to the closed
  form (also past 2^31 - 1 pairs, where the total is -1).
* --skew on 2 gloo ranks: the pairs and the sum equal a NumPy count.
* bench.main on a reduced catalog: one line with the reference's keys;
  its expected lines equal the JAX Engine's on the same catalog; --data
  reads the reference's layout and fails on a wrong small.result.
* bench_planner's chosen order equals JAX's reorder_joins on the same
  relations; bench_microops' dense_probe / dense_expand equal JAX's.
* Each CLI exits 2 under the default device without a card, and a
  subprocess import of each leaves jax and radixhashjoin_tpu unloaded.
* The generators moved out of chip_smoke.py keep their output: digests
  of the contest-shaped catalog and queries (bench.py) and of the data
  and oracle lines of chip_smoke's phases 4 and 4b (now from
  bench_scale), pinned from the chip_smoke.py that defined them inline.

Tolerance: exact equality throughout.
"""

import hashlib
import importlib.util
import io
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radixhashjoin_tpu.config import EngineConfig as JaxConfig
from radixhashjoin_tpu.models import device_catalog as jax_catalog
from radixhashjoin_tpu.models.engine import Engine as JaxEngine
from radixhashjoin_tpu.models.planner import reorder_joins as jax_reorder
from radixhashjoin_tpu.ops import factorized as jfac
from radixhashjoin_tpu.ops.join_dense import dense_expand as jax_expand
from radixhashjoin_tpu.ops.join_dense import dense_probe as jax_probe
from radixhashjoin_tpu.storage import Relation as JaxRelation
from radixhashjoin_tpu.utils import limbs as jax_limbs
from radixhashjoin_tpu.workload import parse_query as jax_parse_query
from radixhashjoin_tpu_torch import (bench, bench_microops, bench_planner,
                                     bench_scale)
from radixhashjoin_tpu_torch.config import EngineConfig
from radixhashjoin_tpu_torch.models import device_catalog
from radixhashjoin_tpu_torch.models.engine import Engine
from radixhashjoin_tpu_torch.ops import factorized as tfac
from radixhashjoin_tpu_torch.ops.join_dense import dense_probe
from radixhashjoin_tpu_torch.oracle import OracleExecutor, format_result
from radixhashjoin_tpu_torch.storage import write_relation
from radixhashjoin_tpu_torch.utils import limbs

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODULES = ("bench_scale", "bench", "bench_planner", "bench_microops",
           "bench_dist_scale", "scale_efficiency")


def _line(q):
    """A query in the work-stream syntax."""
    preds = ([f"{j.slot1}.{j.col1}={j.slot2}.{j.col2}" for j in q.joins]
             + [f"{f.slot}.{f.col}{f.op}{f.value}" for f in q.filters])
    return (f"{' '.join(map(str, q.slots))}|{'&'.join(preds)}|"
            f"{' '.join(f'{p.slot}.{p.col}' for p in q.projections)}")


def _jax_engine(rels):
    return JaxEngine([JaxRelation(list(r.values)) for r in rels],
                     JaxConfig())


def _lines(out):
    return [json.loads(ln) for ln in out.getvalue().splitlines()]


@pytest.fixture
def shrunk(monkeypatch):
    """Both packages' huge-path thresholds, shrunk alike: nodes past 2048
    rows take the windowed pass, in 2048-row windows."""
    for mod in (jfac, tfac):
        monkeypatch.setattr(mod, "_BIG_WAVE_ROWS", 2048)
    for mod in (jax_limbs, limbs):
        monkeypatch.setattr(mod, "_BIG_WINDOW_ROWS", 4 * jax_limbs.WCHUNK)
    for mod in (jax_catalog, device_catalog):
        monkeypatch.setattr(mod, "_NARROW_PLANE_MIN_ROWS", 1024)


# ---- bench_scale: the engine configs, three ways ----

ENGINE_CASES = {
    "star": lambda rng: bench_scale.star(1 << 12, rng, 1 << 10),
    "star_smalldim": lambda rng: bench_scale.star(
        1 << 13, rng, bench_scale.SMALL_DIM_KEYS),
    "zipf": lambda rng: bench_scale.zipf_join(1 << 14, rng, 1 << 10),
    "star_big": lambda rng: bench_scale.star_big(1 << 13, rng, 1 << 10),
    # both facts past the shrunken threshold, a ragged last window
    "chain": lambda rng: bench_scale.chain(4 * 2048 + 77, rng, 300),
}


@pytest.mark.parametrize("name,huge", [
    ("star", False), ("star_smalldim", False), ("zipf", False),
    ("star_big", False), ("chain", False), ("chain", True), ("zipf", True),
    ("star_big", True)])
def test_engine_config_three_ways(name, huge, request):
    if huge:
        request.getfixturevalue("shrunk")
    case = ENGINE_CASES[name](np.random.default_rng(5))
    q = case.query
    assert [format_result(OracleExecutor(case.rels).execute(q),
                          len(q.projections))] == case.expected
    eng = Engine(case.rels, EngineConfig(), device="cpu")
    assert eng.run_workload([[q]]) == case.expected
    assert eng.batch_executor.counters["ftree_queries"] == 1
    jeng = _jax_engine(case.rels)
    assert jeng.run_workload([[jax_parse_query(_line(q))]]) == case.expected


# ---- bench_scale: the dense probes ----

@pytest.mark.parametrize("name", ["dense_uniform", "dense_fk",
                                  "dense_narrow"])
def test_dense_probe_matches_jax_and_closed_form(name):
    gen = torch.Generator().manual_seed(bench_scale.PROBE_SEED)
    probe = getattr(bench_scale, name)(1 << 14, gen)
    got = dense_probe(*probe.args())
    assert bench_scale.check_probe(probe, got) == probe.pairs > 0
    want = jax_probe(jnp.asarray(probe.lvals.numpy()),
                     jnp.int32(int(probe.lcount)),
                     jnp.asarray(probe.rvals.numpy()),
                     jnp.int32(int(probe.rcount)), probe.domain)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))


def test_check_probe_past_int32_pairs():
    """2^16 equal keys a side: 2^32 pairs, so the total is -1 while the
    per-left counts still add up to the closed form."""
    keys = torch.zeros(1 << 16, dtype=torch.int32)
    probe = bench_scale._probe(keys, keys, 8)
    assert probe.pairs == 1 << 32
    assert bench_scale.check_probe(probe, dense_probe(*probe.args())) == -1
    wrong = bench_scale._probe(keys, keys[1:], 8)
    wrong.pairs += 1
    with pytest.raises(AssertionError):
        bench_scale.check_probe(wrong, dense_probe(*wrong.args()))


@pytest.mark.parametrize("part", ["counts", "lo", "order"])
def test_check_probe_holds_each_element(part):
    """A probe result whose total is right but one element is wrong (a
    match moved to the next left row, a first position off by one, two
    rows of the right side's order swapped) fails the check."""
    gen = torch.Generator().manual_seed(bench_scale.PROBE_SEED)
    probe = bench_scale.dense_narrow(1 << 12, gen)
    order, lo, offsets, cum, total = dense_probe(*probe.args())
    assert bench_scale.check_probe(
        probe, (order, lo, offsets, cum, total)) == probe.pairs
    if part == "counts":
        counts = (cum - offsets).clone()
        i = int(torch.nonzero(counts[:-1] > 0)[0])
        counts[i] -= 1
        counts[i + 1] += 1
        cum = torch.cumsum(counts, 0, dtype=torch.int32)
        offsets = cum - counts
    elif part == "lo":
        lo = lo.clone()
        lo[0] += 1
    else:
        order = order.clone()
        order[[0, 1]] = order[[1, 0]]
    with pytest.raises(AssertionError):
        bench_scale.check_probe(probe, (order, lo, offsets, cum, total))


# the CLI's opt-in configs at 2^12 rows: (flags, the metrics printed, the
# generators main draws from its one default_rng(0) stream, in its order,
# and the index of each printed engine line's case)
_N = 1 << 12
OPT_IN_CASES = {
    "all": (["--rows", "12", "--zipf-engine", "--zipf-rows", "12",
             "--star-rows", "12", "--chain-rows", "12"],
            ["dense_probe_uniform_tuples_per_s", "dense_probe_fk_tuples_per_s",
             "dense_probe_narrow_domain_tuples_per_s",
             "star_join_engine_tuples_per_s",
             "star_join_smalldim_engine_tuples_per_s",
             "zipf_join_engine_tuples_per_s", "zipf_join_engine_tuples_per_s",
             "star_join_big_engine_tuples_per_s",
             "chain_join_big_engine_tuples_per_s"],
            [lambda rng: bench_scale.star(_N, rng),
             lambda rng: bench_scale.star(_N, rng, bench_scale.SMALL_DIM_KEYS),
             lambda rng: bench_scale.zipf_join(_N, rng),
             lambda rng: bench_scale.star_big(_N, rng),
             lambda rng: bench_scale.chain(_N, rng)],
            [None, None, None, 0, 1, 2, 2, 3, 4]),
    "zipf_only": (["--zipf-only", "--zipf-rows", "12"],
                  ["zipf_join_engine_tuples_per_s"] * 2,
                  [lambda rng: bench_scale.zipf_join(_N, rng)], [0, 0]),
    "zipf_only_star_chain": (["--zipf-only", "--star-rows", "12",
                              "--chain-rows", "12"],
                             ["star_join_big_engine_tuples_per_s",
                              "chain_join_big_engine_tuples_per_s"],
                             [lambda rng: bench_scale.star_big(_N, rng),
                              lambda rng: bench_scale.chain(_N, rng)],
                             [0, 1]),
}


@pytest.mark.parametrize("name", sorted(OPT_IN_CASES))
def test_main_cpu_opt_in_configs(name):
    """--zipf-engine (factorized, then the materializing cross-check),
    --star-rows, --chain-rows and --zipf-only: the metrics in the CLI's
    order, every line exact, and each engine line's sums those of its
    closed form over the same draws."""
    argv, metrics, gens, case_of = OPT_IN_CASES[name]
    out = io.StringIO()
    assert bench_scale.main(["--device", "cpu", *argv], out) == 0
    lines = _lines(out)
    assert [ln["metric"] for ln in lines] == metrics
    assert all(ln["exact"] is True and ln["value"] == "not measured"
               and set(ln["launches"]) == set(bench_scale.kernels.LAUNCHES)
               for ln in lines)
    rng = np.random.default_rng(0)
    expected = [g(rng).expected[0] for g in gens]
    for ln, i in zip(lines, case_of):
        if i is not None:
            cut = len(ln["sums"])
            assert ln["sums"] == expected[i][:cut]
            assert cut >= min(len(expected[i]), 60)
    if name != "zipf_only_star_chain":
        zipf = [ln for ln in lines if ln["metric"].startswith("zipf")]
        assert [ln["factorized"] for ln in zipf] == [True, False]
        assert all(ln["cross_checked"] for ln in zipf)


def test_main_cpu_lines_and_skew_on_two_gloo_ranks():
    """main with --skew on 2 gloo ranks: every line exact, every metric
    name but the opt-in configs', and the distributed join's pairs and
    sum equal to a NumPy count over the same keys."""
    out = io.StringIO()
    assert bench_scale.main(["--device", "cpu", "--rows", "12", "--skew",
                             "--skew-rows", "4096", "--devices", "2"],
                            out) == 0
    lines = _lines(out)
    assert [ln["metric"] for ln in lines] == [
        "dense_probe_uniform_tuples_per_s", "dense_probe_fk_tuples_per_s",
        "dense_probe_narrow_domain_tuples_per_s",
        "star_join_engine_tuples_per_s",
        "star_join_smalldim_engine_tuples_per_s",
        "skewaware_dist_join_tuples_per_s"]
    assert all(ln["exact"] is True and ln["value"] == "not measured"
               for ln in lines)
    skew = lines[-1]
    gen = torch.Generator().manual_seed(bench_scale.SKEW_SEED)
    lz, rv = (v.numpy() for v in bench_scale.skew_join(4096, gen))
    lvals, lc = np.unique(lz, return_counts=True)
    rvals, rc = np.unique(rv, return_counts=True)
    common, li, ri = np.intersect1d(lvals, rvals, return_indices=True)
    pairs = lc[li].astype(np.int64) * rc[ri]
    assert (skew["devices"], skew["backend"]) == (2, "gloo")
    assert skew["output_pairs"] == int(pairs.sum()) > 0
    assert skew["sum"] == int((common.astype(np.int64) * pairs).sum())
    assert skew["overflow"] == 0


def test_main_rejects_unported_impl(capsys):
    assert bench_scale.main(["--device", "cpu", "--impl", "xla"]) == 2
    assert "not ported" in capsys.readouterr().err


# ---- bench.py: the end-to-end twin ----

TWIN_TUPLES = 5000


def test_bench_twin_line_and_lines_equal_jax():
    out = io.StringIO()
    assert bench.main(["--device", "cpu", "--tuples", str(TWIN_TUPLES)],
                      out) == 0
    line, = _lines(out)
    engine, batches, want = bench.contest_workload(
        lambda rels: Engine(rels, EngineConfig(), device="cpu"), TWIN_TUPLES)
    jeng = _jax_engine(engine.relations)
    assert jeng.run_workload([[jax_parse_query(_line(q)) for q in b]
                              for b in batches]) == want
    assert {"metric", "value", "unit", "vs_baseline", "cold_wall_s",
            *jeng.batch_executor.counters} <= set(line)
    assert (line["metric"], line["value"], line["unit"],
            line["vs_baseline"], line["cold_wall_s"]) == (
        "small_workload_wall_s", "not measured", "s", None, "not measured")
    assert line["queries"] == len(want) == 70
    assert line["ftree_queries"] == 50 and line["exact"] is True


@pytest.mark.parametrize("result", ["intact", "wrong"])
def test_bench_twin_reads_the_reference_layout(tmp_path, result):
    """--data: r0 … r13, small.work and small.result as the reference's
    bench reads them; a small.result that differs fails the run."""
    engine, batches, want = bench.contest_workload(
        lambda rels: Engine(rels, EngineConfig(), device="cpu"), TWIN_TUPLES)
    for i, rel in enumerate(engine.relations):
        write_relation(str(tmp_path / f"r{i}"), rel.values)
    work = [ln for b in batches for ln in [_line(q) for q in b] + ["F"]]
    (tmp_path / "small.work").write_text("\n".join(work) + "\n")
    if result == "wrong":
        want = want[:-1] + ["1 2 3"]
    (tmp_path / "small.result").write_text("\n".join(want) + "\n")
    out = io.StringIO()
    rc = bench.main(["--device", "cpu", "--data", str(tmp_path)], out)
    line, = _lines(out)
    if result == "wrong":
        assert rc == 1 and line["value"] == -1 and "error" in line
    else:
        assert rc == 0 and line["exact"] is True
        assert (line["data"], line["queries"]) == (str(tmp_path), 70)


# ---- bench_planner, bench_microops ----

@pytest.mark.parametrize("log_rows,log_distinct", [(12, 8), (14, 10)])
def test_planner_order_matches_jax(log_rows, log_distinct):
    rels = bench_planner.make_relations(
        1 << log_rows, 1 << log_distinct,
        np.random.default_rng(bench_planner.SEED))
    jrels = [JaxRelation(list(r.values)) for r in rels]
    jq = jax_parse_query(_line(bench_planner.QUERY))
    want = [f"{j.slot1}.{j.col1}={j.slot2}.{j.col2}"
            for j in jax_reorder(jq, jrels).joins]
    assert want != [f"{j.slot1}.{j.col1}={j.slot2}.{j.col2}"
                    for j in jq.joins]
    assert bench_planner.chosen_order(rels) == want
    out = io.StringIO()
    assert bench_planner.main(["--device", "cpu", "--log-rows",
                               str(log_rows), "--log-distinct",
                               str(log_distinct)], out) == 0
    line, = _lines(out)
    assert line["chosen_order"] == want and line["exact_vs_oracle"] is True
    assert line["written"] == line["reordered"] == "not measured"


@pytest.mark.parametrize("n", bench_microops.SIZES)
def test_microops_probe_and_expand_match_jax(n):
    v = bench_microops.keys(n, torch.Generator().manual_seed(0))
    probe, expand = bench_microops.probe_and_expand(v)
    jv = jnp.asarray(v.numpy())
    cnt = jnp.int32(n - bench_microops.DEAD)
    jprobe = jax_probe(jv, cnt, jv, cnt, bench_microops.DOMAIN)
    for g, w in zip(probe, jprobe):
        assert np.array_equal(g.numpy(), np.asarray(w))
    for g, w in zip(expand, jax_expand(*jprobe[:4], n)):
        assert np.array_equal(g.numpy(), np.asarray(w))


def test_microops_main_cpu():
    out = io.StringIO()
    assert bench_microops.main(["--device", "cpu"], out) == 0
    lines = _lines(out)
    assert len(lines) == 9 * len(bench_microops.SIZES)
    assert all(ln["value"] == "not measured" for ln in lines)
    assert {ln["op"] for ln in lines if ln.get("exact")} == {
        "scatter_add_domain", "gather_domain", "dense_probe", "dense_expand"}


# ---- the CLIs ----

@pytest.mark.parametrize("mod", MODULES)
def test_cli_default_device_exits_2_without_a_card(mod):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device runs")
    proc = subprocess.run([sys.executable, "-m",
                           f"radixhashjoin_tpu_torch.{mod}"],
                          capture_output=True, text=True, cwd=REPO,
                          timeout=240)
    assert proc.returncode == 2, proc.stderr
    assert "--device cpu" in proc.stderr and proc.stdout == ""


@pytest.mark.parametrize("mod", MODULES)
def test_import_leaves_jax_out(mod):
    code = (f"import sys\nimport radixhashjoin_tpu_torch.{mod}\n"
            "print([m for m in ('jax', 'radixhashjoin_tpu') "
            "if m in sys.modules])\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=REPO, timeout=240)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"


# ---- the generators moved out of chip_smoke.py ----

def _digest(obj) -> str:
    h = hashlib.sha256()

    def feed(x):
        if isinstance(x, np.ndarray):
            h.update(f"a{x.shape}".encode())
            h.update(np.ascontiguousarray(x, dtype="<u8").tobytes())
        elif isinstance(x, str):
            h.update(x.encode() + b"\n")
        else:
            h.update(b"[")
            for e in x:
                feed(e)
            h.update(b"]")
    feed(obj)
    return h.hexdigest()[:16]


# (columns, tree query lines, fallback query lines and kinds) of the
# contest-shaped workload, by catalog size
CONTEST_DIGESTS = {
    270_000: ("e0a26e23f89ff310", "57df3eb49f3509ad", "df30d6b4cb574459"),
    5000: ("fa54f8e61789ec88", "eae22392910af26e", "662fb57f16b31727"),
}
# (columns, oracle lines, query) of each cell of chip_smoke's phase 4 at
# zipf / star rows 2^14, 2^10 keys, triangle rows 2^12, and of phase 4b at
# 2^16 + 12345 / 2^16 + 4099 fact rows, 2^10 keys
ZIPF = ("1c53f06d92fcc8d5", "90722d017b41b03b", "671e6ad6f7058e5e")
STAR = ("489768a5288b88ca", "c08dc914e9bcc000", "b118a476026979bd")
TRIANGLE = ("effa73c703b245c6", "65faa180142b29d9", "9ddf3da9f5e9bfe0")
PHASE_DIGESTS = {
    "zipf": ZIPF, "dist_zipf_ftree": ZIPF, "dist_zipf_heavy": ZIPF,
    "dist_zipf_exchange": ZIPF, "star": STAR, "star_per_query": STAR,
    "star_batch_materialized": STAR, "star_batch_sort": STAR,
    "dist_star_exchange": STAR, "triangle_per_query": TRIANGLE,
    "triangle_batch": TRIANGLE,
    "zipf_huge": ("6f6e7cf677ec5567", "f4ecd68ca35a5ca3", "671e6ad6f7058e5e"),
    "star_huge": ("1fcc1e3a77d6623b", "2176e8205f6ce944", "b118a476026979bd"),
}


@pytest.mark.parametrize("total", sorted(CONTEST_DIGESTS))
def test_contest_generators_unchanged(total):
    rng = np.random.default_rng(bench.CONTEST_SEED)
    cols = bench.make_contest_catalog(rng, total=total)
    tree = bench.make_tree_queries(rng, cols)
    from radixhashjoin_tpu_torch.storage import Relation
    planner = Engine([Relation(c) for c in cols], EngineConfig(),
                     device="cpu").batch_executor
    extra = bench.make_fallback_queries(
        np.random.default_rng(bench.FALLBACK_SEED), cols, planner)
    assert (_digest(cols), _digest(tree), _digest(list(extra))) \
        == CONTEST_DIGESTS[total]


@pytest.fixture(scope="module")
def phase_cells():
    """Each cell chip_smoke's phases 4 and 4b hand to their runners, at
    small sizes, with the runners replaced by recorders."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    cells = {}

    def record(name, rels, q, expected, *_a, **_k):
        cells[name] = (_digest([list(r.values) for r in rels]),
                       _digest(list(expected)), _digest(repr(q)))
        return {"warm_query_s": []}

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cs, "_scale_run", record)
        mp.setattr(cs, "_per_query_run", record)
        mp.setattr(cs, "_batch_fallback_run", record)
        mp.setattr(cs, "_dist_run", lambda *a: (record(*a), {}))
        mp.setattr(cs, "_huge_run", lambda *a: (record(*a), {}))
        dev = torch.device("cpu")
        cs.phase_scale(dev, zipf_rows=1 << 14, star_rows=1 << 14,
                       n_keys=1 << 10, triangle_rows=1 << 12)
        cs.phase_huge(dev, zipf_rows=(1 << 16) + 12345,
                      star_rows=(1 << 16) + 4099, n_keys=1 << 10)
    return cells


@pytest.mark.parametrize("cell", sorted(PHASE_DIGESTS))
def test_chip_smoke_phase_data_unchanged(cell, phase_cells):
    assert phase_cells[cell] == PHASE_DIGESTS[cell]
