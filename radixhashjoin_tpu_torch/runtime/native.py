"""ctypes bindings of the native host runtime (counterpart:
radixhashjoin_tpu/runtime/native.py).

`native/rhj_host.cpp` compiles at first use with the host C++ compiler
(`$CXX`, else `c++`) into `build/` beside the package. The library's name
carries a hash of the source, the compiler and the flags, as kernels.py
names its nvcc builds, so an edited source never loads a stale build; a
build writes a temporary file and renames it, so processes that build at
once never load half a library.

There is no quiet fallback: a failed build raises with the compiler's
output. EngineConfig(use_native_runtime=False) (the CLI's --no-native)
runs the Python loader and parser (storage.py, workload.py), which give
the same relations, stats and queries.

`CALLS` counts the calls into the library ("load", "parse", "format"), so
a run can show that it went through it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..storage import ColumnStats, Relation
from ..workload import FilterPred, JoinPred, Projection, Query

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "native",
                      "rhj_host.cpp")
BUILD_DIR = os.path.join(_PKG_DIR, "build")
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-pthread", "-shared"]
CXX_DEFAULT = "c++"

_OPS = ["=", "<", ">"]
_U64_MASK = (1 << 64) - 1
# the tape's first allocation (8 words a character covers any stream the
# parser accepts); a longer tape reallocates once
_TAPE_MIN_WORDS = 4096
_TAPE_WORDS_PER_CHAR = 8

CALLS = {"load": 0, "parse": 0, "format": 0}

_libs: Dict[str, ctypes.CDLL] = {}


class _RhjRelation(ctypes.Structure):
    _fields_ = [("num_tuples", ctypes.c_uint64),
                ("num_columns", ctypes.c_uint64),
                ("data", ctypes.POINTER(ctypes.c_uint64)),
                ("map_base", ctypes.c_void_p),
                ("map_len", ctypes.c_uint64)]


def compiler() -> str:
    """The host C++ compiler: $CXX, else `c++`."""
    return os.environ.get("CXX") or CXX_DEFAULT


def library_path() -> str:
    """Where the library of SOURCE lives; its name hashes the source, the
    compiler and the flags."""
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(
            f.read() + " ".join([compiler(), *CXX_FLAGS]).encode())
    return os.path.join(BUILD_DIR, f"librhj_host_{digest.hexdigest()[:12]}.so")


def build() -> dict:
    """Compile SOURCE unless its library exists. Returns {"path", "seconds"
    (0.0 when it existed), "log"}; raises RuntimeError with the compiler's
    output when the build fails."""
    path = library_path()
    if os.path.exists(path):
        return {"path": path, "seconds": 0.0, "log": ""}
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = [compiler(), *CXX_FLAGS, "-o", tmp, SOURCE]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
    except OSError as e:
        raise RuntimeError(
            f"cannot build the native host runtime: {' '.join(cmd)}: {e} "
            f"(set $CXX, or run with use_native_runtime=False / "
            f"--no-native)") from e
    if proc.returncode != 0:
        raise RuntimeError(
            f"cannot build the native host runtime: {' '.join(cmd)} exited "
            f"{proc.returncode} (run with use_native_runtime=False / "
            f"--no-native for the Python loader):\n{proc.stderr}")
    os.replace(tmp, path)
    return {"path": path, "seconds": time.perf_counter() - t0,
            "log": proc.stdout + proc.stderr}


def _load_lib() -> ctypes.CDLL:
    path = build()["path"]
    lib = _libs.get(path)
    if lib is not None:
        return lib
    lib = ctypes.CDLL(path)
    lib.rhj_open.argtypes = [ctypes.c_char_p, ctypes.POINTER(_RhjRelation)]
    lib.rhj_open.restype = ctypes.c_int
    lib.rhj_close.argtypes = [ctypes.POINTER(_RhjRelation)]
    lib.rhj_close.restype = None
    lib.rhj_stats.argtypes = [ctypes.POINTER(_RhjRelation)] + \
        [ctypes.POINTER(ctypes.c_uint64)] * 3
    lib.rhj_stats.restype = None
    lib.rhj_parse_work.argtypes = [ctypes.c_char_p,
                                   ctypes.POINTER(ctypes.c_longlong),
                                   ctypes.c_longlong]
    lib.rhj_parse_work.restype = ctypes.c_longlong
    lib.rhj_format_results.argtypes = [
        ctypes.POINTER(ctypes.c_ulonglong), ctypes.POINTER(ctypes.c_longlong),
        ctypes.POINTER(ctypes.c_ubyte), ctypes.c_longlong, ctypes.c_char_p,
        ctypes.c_longlong]
    lib.rhj_format_results.restype = ctypes.c_longlong
    _libs[path] = lib
    return lib


def load_relation_native(path: str) -> Relation:
    """mmap a relation file and take its per-column stats in C++ (one
    thread a column). The columns are read-only views of the mapping, which
    stays for the process's lifetime (relations load once, as in the
    reference's load-at-init contract, join.cpp:18-22)."""
    lib = _load_lib()
    CALLS["load"] += 1
    rel = _RhjRelation()
    rc = lib.rhj_open(path.encode(), ctypes.byref(rel))
    if rc == -1:
        raise FileNotFoundError(f"{path}: cannot open")
    if rc != 0:
        raise AssertionError(f"{path}: native loader error {rc}")
    t, c = rel.num_tuples, rel.num_columns
    if t * c:
        base = np.ctypeslib.as_array(rel.data, shape=(t * c,))
        # the mapping is PROT_READ: a write would kill the process
        base.flags.writeable = False
    else:
        base = np.zeros(0, dtype=np.uint64)
    cols = [base[i * t:(i + 1) * t] for i in range(c)]
    mins = (ctypes.c_uint64 * c)()
    maxs = (ctypes.c_uint64 * c)()
    dist = (ctypes.c_uint64 * c)()
    lib.rhj_stats(ctypes.byref(rel), mins, maxs, dist)
    out = Relation(cols, path=path, compute_stats=False)
    out.set_stats([ColumnStats(int(mins[i]), int(maxs[i]), int(dist[i]))
                   for i in range(c)])
    out._native_handle = rel        # the mapping's descriptor
    return out


def parse_work_native(text: str) -> List[List[Query]]:
    """Parse a whole work stream with the C++ tape parser. Raises
    ValueError on a malformed stream."""
    lib = _load_lib()
    CALLS["parse"] += 1
    raw = text.encode()
    cap = max(_TAPE_MIN_WORDS, _TAPE_WORDS_PER_CHAR * len(raw))
    tape = (ctypes.c_longlong * cap)()
    n = lib.rhj_parse_work(raw, tape, cap)
    if n < 0:
        cap = -n
        tape = (ctypes.c_longlong * cap)()
        n = lib.rhj_parse_work(raw, tape, cap)
    if n == 0:
        raise ValueError("malformed work stream")
    words = tape[:n]
    batches: List[List[Query]] = []
    cur: List[Query] = []
    i = 0
    while True:
        w = words[i]
        if w == -2:
            break
        if w == -1:
            if cur:
                batches.append(cur)
                cur = []
            i += 1
            continue
        nslots = w
        i += 1
        slots = [int(x) for x in words[i:i + nslots]]
        i += nslots
        njoins = words[i]
        i += 1
        joins = [JoinPred(*map(int, words[i + 4 * k:i + 4 * k + 4]))
                 for k in range(njoins)]
        i += 4 * njoins
        nfil = words[i]
        i += 1
        filters = [FilterPred(int(words[i + 4 * k]), int(words[i + 4 * k + 1]),
                              _OPS[words[i + 4 * k + 2]],
                              int(words[i + 4 * k + 3]) & _U64_MASK)
                   for k in range(nfil)]
        i += 4 * nfil
        nproj = words[i]
        i += 1
        projs = [Projection(int(words[i + 2 * k]), int(words[i + 2 * k + 1]))
                 for k in range(nproj)]
        i += 2 * nproj
        cur.append(Query(slots, joins, filters, projs))
    if cur:
        batches.append(cur)
    return batches


def format_results_native(results: Sequence[Optional[List[int]]],
                          proj_counts: Sequence[int]) -> str:
    """The result lines (each ending in a newline) of per-query sums (None:
    a NULL line), formatted in C++."""
    lib = _load_lib()
    CALLS["format"] += 1
    nq = len(results)
    sums: List[int] = []
    nulls = (ctypes.c_ubyte * nq)()
    counts = (ctypes.c_longlong * nq)(*proj_counts)
    for q, r in enumerate(results):
        if r is None:
            nulls[q] = 1
            sums.extend([0] * proj_counts[q])
        else:
            sums.extend(r)
    sums_arr = (ctypes.c_ulonglong * len(sums))(*sums)
    cap = 32 * max(1, len(sums)) + 8 * nq
    buf = ctypes.create_string_buffer(cap)
    n = lib.rhj_format_results(sums_arr, counts, nulls, nq, buf, cap)
    if n < 0:
        cap = -n
        buf = ctypes.create_string_buffer(cap)
        n = lib.rhj_format_results(sums_arr, counts, nulls, nq, buf, cap)
    return buf.raw[:n].decode()
