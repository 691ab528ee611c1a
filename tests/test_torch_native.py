"""The port's native host runtime (radixhashjoin_tpu_torch/runtime: the
C++ loader with load-time stats, the tape parser and the result
formatter, built at first use from runtime/native/rhj_host.cpp) against
the port's Python loader, parser and formatter and the JAX package's, on
relation files written into tmp_path from seeded numpy arrays and on
generated work streams: equal columns, stats, queries and lines (exact,
tolerance 0). A failed build raises; use_native_runtime=False runs the
Python side.
"""

import dataclasses
import io
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from radixhashjoin_tpu import storage as jstorage
from radixhashjoin_tpu import workload as jworkload
from radixhashjoin_tpu_torch import oracle as toracle
from radixhashjoin_tpu_torch import storage as tstorage
from radixhashjoin_tpu_torch import workload as tworkload
from radixhashjoin_tpu_torch.config import EngineConfig
from radixhashjoin_tpu_torch.models.engine import Engine, main
from radixhashjoin_tpu_torch.runtime import native

torch.set_num_threads(1)

U64 = np.uint64
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _relations(rng):
    """name -> columns: empty, one column, wide, values past 2**63, the
    bincount stats regime and the sort regime."""
    n = 3000
    below = (1 << 20) + 4096
    return {
        "empty": [np.zeros(0, U64) for _ in range(3)],
        "one_row_one_col": [np.array([2**64 - 1], U64)],
        "one_col": [rng.integers(0, 50, n).astype(U64)],
        "wide": [rng.integers(0, 1 << int(rng.integers(1, 64)), n,
                              dtype=U64) for _ in range(16)],
        "past_2_63": [rng.integers(2**63, 2**64 - 1, n, dtype=U64),
                      np.full(n, 2**64 - 1, U64),
                      rng.integers(0, 2**64 - 1, n, dtype=U64)],
        "below_rows": [rng.integers((1 << 20) - 7, below, below).astype(U64),
                       rng.integers(1 << 20, 1 << 40, below).astype(U64)],
    }


def _stats(rel):
    return [dataclasses.astuple(s) for s in rel.stats]


def test_loader_matches_python_and_reference(tmp_path):
    for name, cols in _relations(np.random.default_rng(1)).items():
        path = str(tmp_path / name)
        tstorage.write_relation(path, cols)
        got = native.load_relation_native(path)
        ours = tstorage.load_relation(path)
        ref = jstorage.load_relation(path)
        assert (got.num_tuples, got.num_columns) == (
            ours.num_tuples, ours.num_columns) == (ref.num_tuples,
                                                   ref.num_columns), name
        for a, b, c in zip(got.values, ours.values, ref.values):
            assert a.dtype == np.uint64
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, c)
        assert _stats(got) == _stats(ours) == _stats(ref), name
        assert got.path == path


def test_loader_columns_are_read_only(tmp_path):
    """The columns view a read-only mapping: numpy refuses a write (the
    write itself would kill the process), and the catalog, the narrow
    copies and the engine only read them."""
    path = str(tmp_path / "r0")
    cols = [np.arange(10, dtype=U64), np.arange(10, dtype=U64) * 3]
    tstorage.write_relation(path, cols)
    rel = native.load_relation_native(path)
    for col in rel.values:
        assert not col.flags.writeable
        with pytest.raises(ValueError, match="read-only"):
            col[0] = 5
    np.testing.assert_array_equal(rel.narrow_column(1),
                                  cols[1].astype(np.int32))
    eng = Engine.from_paths([path, path], EngineConfig(), device="cpu")
    q = tworkload.parse_query("0 1|0.0=1.0&0.1>5|0.1 1.0")
    assert eng.run_batch([q]) == toracle.run_workload(
        [tstorage.load_relation(path)] * 2, [[q]])
    np.testing.assert_array_equal(rel.values[1], cols[1])


def test_loader_errors(tmp_path):
    path = str(tmp_path / "bad")
    tstorage.write_relation(path, [np.arange(4, dtype=U64)])
    with open(path, "ab") as f:
        f.write(b"\0" * 8)
    with pytest.raises(AssertionError, match="native loader error"):
        native.load_relation_native(path)
    with pytest.raises(FileNotFoundError):
        native.load_relation_native(str(tmp_path / "missing"))
    with open(path, "wb") as f:
        f.write(b"\0" * 9)
    with pytest.raises(AssertionError):
        native.load_relation_native(path)


def _work(rng, n_queries=40, n_rels=5, big=False):
    """A work stream: joins of any shape, every filter op with values up
    to 2**64 - 1 (`big`), projections, batches of 1-9 queries ended by F,
    blank lines between some."""
    lines = []
    for qi in range(n_queries):
        nslots = int(rng.integers(1, 5))
        slots = [int(rng.integers(0, n_rels)) for _ in range(nslots)]
        preds = []
        for _ in range(int(rng.integers(0, 4))):
            a, b = (int(x) for x in rng.integers(0, nslots, 2))
            preds.append(f"{a}.{int(rng.integers(0, 3))}"
                         f"{rng.choice(['=', '<', '>'])}"
                         f"{b}.{int(rng.integers(0, 3))}")
        for op in ("=", "<", ">"):
            if rng.random() < 0.6:
                hi = 2**64 - 1 if big and rng.random() < 0.5 else 1000
                v = int(rng.integers(0, hi, dtype=U64, endpoint=True))
                preds.append(f"{int(rng.integers(0, nslots))}."
                             f"{int(rng.integers(0, 3))}{op}{v}")
        rng.shuffle(preds)
        projs = [f"{int(s)}.{int(rng.integers(0, 3))}"
                 for s in rng.integers(0, nslots, int(rng.integers(1, 4)))]
        lines.append(f"{' '.join(map(str, slots))}|{'&'.join(preds)}|"
                     f"{' '.join(projs)}")
        if rng.random() < 0.2:
            lines.append("F")
        if rng.random() < 0.1:
            lines.append("")
    lines.append("F")
    return "\n".join(lines) + "\n"


def _fields(q):
    return (list(q.slots), [dataclasses.astuple(j) for j in q.joins],
            [dataclasses.astuple(f) for f in q.filters],
            [dataclasses.astuple(p) for p in q.projections])


def _shape(batches):
    return [[_fields(q) for q in b] for b in batches]


@pytest.mark.parametrize("seed", range(4))
def test_parser_matches_python_and_reference(seed):
    text = _work(np.random.default_rng(seed), big=seed % 2 == 1)
    got = native.parse_work_native(text)
    ours = tworkload.parse_work_stream(text.splitlines(True))
    ref = jworkload.parse_work_stream(text.splitlines(True))
    assert _shape(got) == _shape(ours) == _shape(ref)
    assert len(got) > 2
    ops = {f.op for b in got for q in b for f in q.filters}
    assert ops == {"=", "<", ">"}
    if seed % 2:
        assert max(f.value for b in got for q in b for f in q.filters) \
            >= 2**63
    # no trailing F, no final newline: the same batches
    assert _shape(native.parse_work_native(text.rstrip("F\n"))) == _shape(
        tworkload.parse_work_stream(text.rstrip("F\n").splitlines(True)))
    assert native.parse_work_native("") == []


def test_parser_grows_a_short_tape(monkeypatch):
    """A tape cap smaller than the stream's tape: the parser reports the
    size it needs and the second call fills it."""
    text = _work(np.random.default_rng(9), n_queries=12)
    want = _shape(native.parse_work_native(text))
    monkeypatch.setattr(native, "_TAPE_MIN_WORDS", 3)
    monkeypatch.setattr(native, "_TAPE_WORDS_PER_CHAR", 0)
    assert _shape(native.parse_work_native(text)) == want


@pytest.mark.parametrize("text", [
    "garbage\n", "0 1\n", "0 1|0.0=|0.0\n", "0|0.0~3|0.0\n", "0|0.0=1|x\n",
    "0|0.0<18446744073709551616|0.0\n", "0 -1|0.0=1.0|0.0\n",
    "0|0.0=1.0\nF\n"])
def test_parser_rejects_garbage(text):
    with pytest.raises(ValueError, match="malformed"):
        native.parse_work_native(text)


def test_formatter_matches_format_result():
    results = [None, [0], [2**64 - 1, 1, 2**63], None, [], [12345678901234]]
    counts = [2, 1, 3, 1, 0, 1]
    want = "".join(toracle.format_result(r, n) + "\n"
                   for r, n in zip(results, counts))
    assert native.format_results_native(results, counts) == want
    assert "NULL NULL\n" in want and str(2**64 - 1) in want
    assert native.format_results_native([], []) == ""
    many = [[2**64 - 1] * 50] * 40        # past the first buffer's cap
    assert native.format_results_native(many, [50] * 40) == "".join(
        toracle.format_result(r, 50) + "\n" for r in many)


@pytest.mark.parametrize("cxx", ["/nonexistent/c++", "false"])
def test_failed_build_raises(monkeypatch, cxx):
    """No quiet fallback: a compiler that is missing or fails raises with
    its command, and the library's name follows the compiler, so the
    failure is not hidden by an earlier build."""
    monkeypatch.setenv("CXX", cxx)
    assert not os.path.exists(native.library_path())
    with pytest.raises(RuntimeError, match="native host runtime"):
        native.load_relation_native("unused")
    with pytest.raises(RuntimeError, match="--no-native"):
        Engine.from_paths(["unused"], EngineConfig(), device="cpu")


def test_main_native_and_python_agree(tmp_path):
    """models/engine.main through the C++ loader, parser and formatter
    and through the Python ones: the same lines, the oracle's; the
    library is called for each."""
    rng = np.random.default_rng(5)
    paths = []
    for i in range(5):
        paths.append(str(tmp_path / f"r{i}"))
        tstorage.write_relation(paths[-1], [
            rng.integers(0, 40, 200).astype(U64) for _ in range(3)])
    text = _work(np.random.default_rng(6), n_queries=20)
    stream = "\n".join(paths + ["Done"]) + "\n" + text
    rels = [tstorage.load_relation(p) for p in paths]
    want = toracle.run_workload(rels, tworkload.parse_work_stream(
        text.splitlines(True)))
    outs = {}
    for use in (True, False):
        before = dict(native.CALLS)
        out = io.StringIO()
        main(io.StringIO(stream), out, EngineConfig(use_native_runtime=use),
             device="cpu")
        outs[use] = out.getvalue().splitlines()
        grew = {k: native.CALLS[k] - before[k] for k in before}
        assert grew == ({"load": 5, "parse": 1, "format": 1} if use
                        else {"load": 0, "parse": 0, "format": 0})
    assert outs[True] == outs[False] == want


def test_cli_exit_codes(tmp_path):
    """Unreadable relations and a malformed work stream exit 1 through
    the native runtime, as through the Python one."""
    path = str(tmp_path / "r0")
    tstorage.write_relation(path, [np.arange(4, dtype=U64)])
    for stream in (f"{tmp_path / 'missing'}\nDone\n0|0.0=1|0.0\nF\n",
                   f"{path}\nDone\n0|0.0=|0.0\nF\n"):
        for flags in ([], ["--no-native"]):
            proc = subprocess.run(
                [sys.executable, "-m", "radixhashjoin_tpu_torch", "--device",
                 "cpu", *flags], input=stream, capture_output=True,
                text=True, cwd=REPO, timeout=240)
            assert proc.returncode == 1, proc.stderr
            assert proc.stdout == ""
