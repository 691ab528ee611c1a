"""Build and bind the hand-written Hopper kernels (csrc/*.cu).

Each source compiles with nvcc into a shared library of its own with a
plain C interface (no PyTorch headers, so a build takes seconds), at
first use, into `build/` beside this file; the nvcc processes of all
sources that need building start together. A library's name carries a
hash of its own source and the flags, so an edited source never loads a
stale build. Nothing here runs at import time: the CPU tests import this
module on machines with no nvcc and no card.

    csrc/tables.cu  rhj_weighted_bincount, rhj_table_gather,
                    rhj_table_gather2
    csrc/radix.cu   rhj_radix_histogram, rhj_rank_hist
    csrc/select.cu  rhj_select
    csrc/probe.cu   rhj_probe, rhj_probe_scratch_bytes

A missing nvcc, a failed build, a refused launch or a wrong operand
raises. There is no fallback: the ops modules send only CUDA tensors
here, and a CUDA tensor either runs the kernel or fails.

`LAUNCHES` counts kernel launches per wrapper ("bincount", "gather",
"gather2", "radix_hist", "rank_hist"), so a run can show that a path
went through these kernels; `counted(fn)` reads the launches of one
call. `SELECT_LAUNCHES` and `PROBE_LAUNCHES` count `select_cuda`'s and
`probe_cuda`'s launches apart from them: a traced benchmark run compares
LAUNCHES with the csrc kernels its capture knows by name, and the select
and probe kernels are not among those yet.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from typing import Dict, Optional, Tuple, Union

import torch

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
SOURCES = {name: os.path.join(_PKG_DIR, "csrc", f"{name}.cu")
           for name in ("tables", "radix", "select", "probe")}
BUILD_DIR = os.path.join(_PKG_DIR, "build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]
NVCC_FALLBACK = "/usr/local/cuda/bin/nvcc"

# mirror kHistMaxBins / kRankMaxBins of csrc/radix.cu (shared memory)
RADIX_HIST_MAX_BINS = 32 * 1024
RANK_HIST_MAX_BINS = 227 * 1024 // 8 - 1
RANK_BLOCK = 2048
# mirror kMaxPreds / kTile of csrc/select.cu
SELECT_MAX_PREDS = 4
SELECT_TILE = 4096

LAUNCHES = {"bincount": 0, "gather": 0, "gather2": 0, "radix_hist": 0,
            "rank_hist": 0}
SELECT_LAUNCHES = 0
PROBE_LAUNCHES = 0

_libs: Dict[str, ctypes.CDLL] = {}


def counted(fn):
    """(fn(), the launches it made): every count is set to 0 before it."""
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    result = fn()
    return result, dict(LAUNCHES)


def find_nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, then PATH, then NVCC_FALLBACK.
    Raises when none exists."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        cands.append(on_path)
    cands.append(NVCC_FALLBACK)
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        f"nvcc not found (looked in $CUDA_HOME/bin, PATH, {NVCC_FALLBACK}):"
        f" the CUDA kernels of csrc/ cannot be built")


def library_path(name: str) -> str:
    """Where the library of SOURCES[name] lives; the name hashes that
    source and the flags."""
    with open(SOURCES[name], "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}_{digest.hexdigest()[:12]}.so")


def build(names=None) -> dict:
    """Compile every source of `names` (default: all of SOURCES) whose
    library does not exist yet, one nvcc per source, all started
    together. Returns {"paths": {name: path}, "seconds": wall time of the
    builds (0.0 when all existed), "log"}. Raises on any failure."""
    paths = {name: library_path(name)
             for name in (SOURCES if names is None else names)}
    missing = [name for name, p in paths.items() if not os.path.exists(p)]
    if not missing:
        return {"paths": paths, "seconds": 0.0, "log": ""}
    nvcc = find_nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for name in missing:
        tmp = f"{paths[name]}.{os.getpid()}.tmp"
        procs[name] = (tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", tmp, SOURCES[name]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs, failed = [], []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        logs.append(f"[{name}.cu]\n{out}")
        if proc.returncode != 0:
            failed.append(f"{name}.cu (exit {proc.returncode})")
        else:
            os.replace(tmp, paths[name])   # atomic: never a half library
    seconds = time.perf_counter() - t0
    log = "".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed for {', '.join(failed)}:\n{log}")
    return {"paths": paths, "seconds": seconds, "log": log}


def _bind(name: str, lib: ctypes.CDLL) -> None:
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    if name == "select":
        lib.rhj_select.argtypes = [ptr, i64, ptr, i64, ptr, ptr, i32, ptr,
                                   ptr, ptr, i32, ptr, i64, ptr, ptr, i32,
                                   ptr]
        lib.rhj_select.restype = i32
    elif name == "probe":
        lib.rhj_probe_scratch_bytes.argtypes = [i64, i64]
        lib.rhj_probe_scratch_bytes.restype = i64
        lib.rhj_probe.argtypes = [ptr, i64, ptr, i64, ptr, i64, ptr, i64,
                                  ptr, ptr, ptr, ptr, ptr, i32, ptr]
        lib.rhj_probe.restype = i32
    elif name == "tables":
        lib.rhj_weighted_bincount.argtypes = [ptr, ptr, i64, ptr, i32, i32,
                                              ptr]
        lib.rhj_weighted_bincount.restype = i32
        lib.rhj_table_gather.argtypes = [ptr, i32, ptr, i64, ptr, i32, ptr]
        lib.rhj_table_gather.restype = i32
        lib.rhj_table_gather2.argtypes = [ptr, i32, ptr, i64, ptr, ptr, i32,
                                          ptr]
        lib.rhj_table_gather2.restype = i32
    else:
        lib.rhj_radix_histogram.argtypes = [ptr, i64, ptr, ptr, i32, i32,
                                            ptr]
        lib.rhj_radix_histogram.restype = i32
        lib.rhj_rank_hist.argtypes = [ptr, i64, i32, ptr, ptr, ptr]
        lib.rhj_rank_hist.restype = i32


def _load(name: str) -> ctypes.CDLL:
    """The bound library of SOURCES[name], built at first use: only that
    source, so a path that launches one library's kernels never waits for
    the others' nvcc."""
    if name not in _libs:
        lib = ctypes.CDLL(build((name,))["paths"][name])
        _bind(name, lib)
        _libs[name] = lib
    return _libs[name]


def _check(name: str, t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != torch.int32:
        raise TypeError(f"{name}: expected int32, got {t.dtype}")
    if t.dim() != 1:
        raise ValueError(f"{name}: expected 1-D, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def _launch_env(t: torch.Tensor):
    """SM count and current stream of the device holding `t`. The C
    entries launch on the CUDA runtime's current device, so every call
    runs inside `torch.cuda.device(t.device)`."""
    stream = torch.cuda.current_stream(t.device).cuda_stream
    sms = torch.cuda.get_device_properties(t.device).multi_processor_count
    return sms, stream


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def weighted_bincount_cuda(idxs: torch.Tensor, weights: torch.Tensor,
                           n_bins: int, out: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """int32[n_bins]: out[b] += sum of weights[i] over idxs[i] == b,
    indices outside [0, n_bins) dropped; `out` is a new zero table unless
    the caller passes its accumulator (int32[n_bins] on idxs' card, which
    the kernel adds into and returns). Caller contract: weights >= 0 and
    every bin's total, accumulator included, < 2**31."""
    _check("idxs", idxs)
    _check("weights", weights)
    if weights.shape != idxs.shape or weights.device != idxs.device:
        raise ValueError("idxs/weights: shape or device mismatch")
    n_bins = int(n_bins)
    if not 0 <= n_bins < 2**31:
        raise ValueError(f"n_bins out of range: {n_bins}")
    if out is None:
        out = torch.zeros(n_bins, dtype=torch.int32, device=idxs.device)
    else:
        _check("out", out)
        if out.shape[0] != n_bins or out.device != idxs.device:
            raise ValueError(f"out: expected {n_bins} bins on {idxs.device}, "
                             f"got {out.shape[0]} on {out.device}")
    n = idxs.shape[0]
    if n == 0 or n_bins == 0:
        return out
    lib = _load("tables")
    sms, stream = _launch_env(idxs)
    with torch.cuda.device(idxs.device):
        err = lib.rhj_weighted_bincount(idxs.data_ptr(), weights.data_ptr(),
                                        n, out.data_ptr(), n_bins, sms,
                                        stream)
    _raise_on(err, "rhj_weighted_bincount")
    LAUNCHES["bincount"] += 1
    return out


def table_gather_cuda(table: torch.Tensor, keys: torch.Tensor
                      ) -> torch.Tensor:
    """int32[n]: table[keys[i]] where 0 <= keys[i] < len(table), else 0.
    The result shares keys' offset within 16 bytes (a view of a buffer up
    to 3 elements longer), so the kernel moves both 16 bytes at a time."""
    _check("table", table)
    _check("keys", keys)
    if table.device != keys.device:
        raise ValueError("table/keys: device mismatch")
    n_bins = table.shape[0]
    if n_bins >= 2**31:
        raise ValueError(f"table too long for int32 keys: {n_bins}")
    n = keys.shape[0]
    if n == 0 or n_bins == 0:
        return torch.zeros(n, dtype=torch.int32, device=keys.device)
    off = keys.data_ptr() % 16 // 4
    out = torch.empty(n + off, dtype=torch.int32, device=keys.device)[off:]
    lib = _load("tables")
    sms, stream = _launch_env(keys)
    with torch.cuda.device(keys.device):
        err = lib.rhj_table_gather(table.data_ptr(), n_bins, keys.data_ptr(),
                                   n, out.data_ptr(), sms, stream)
    _raise_on(err, "rhj_table_gather")
    LAUNCHES["gather"] += 1
    return out


def table_gather2_cuda(pairs: torch.Tensor, keys: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int32[n], int32[n]): pairs[keys[i], 0] and pairs[keys[i], 1] where
    0 <= keys[i] < len(pairs), else 0; one launch reads each key once and
    a key's two values in one 8-byte read. pairs: int32[n_bins, 2],
    contiguous (two tables interleaved). Both results share keys' offset
    within 16 bytes, as table_gather_cuda's does."""
    _check("keys", keys)
    if pairs.device != keys.device:
        raise ValueError("pairs/keys: device mismatch")
    if (pairs.dtype != torch.int32 or pairs.dim() != 2
            or pairs.shape[1] != 2 or not pairs.is_contiguous()):
        raise ValueError(f"pairs: expected a contiguous int32[n, 2], got "
                         f"{pairs.dtype}{tuple(pairs.shape)}")
    n_bins = pairs.shape[0]
    if n_bins >= 2**31:
        raise ValueError(f"table too long for int32 keys: {n_bins}")
    n = keys.shape[0]
    if n == 0 or n_bins == 0:
        zeros = torch.zeros(n, dtype=torch.int32, device=keys.device)
        return zeros, zeros.clone()
    off = keys.data_ptr() % 16 // 4
    out_a = torch.empty(n + off, dtype=torch.int32, device=keys.device)[off:]
    out_b = torch.empty(n + off, dtype=torch.int32, device=keys.device)[off:]
    lib = _load("tables")
    sms, stream = _launch_env(keys)
    with torch.cuda.device(keys.device):
        err = lib.rhj_table_gather2(pairs.data_ptr(), n_bins, keys.data_ptr(),
                                    n, out_a.data_ptr(), out_b.data_ptr(),
                                    sms, stream)
    _raise_on(err, "rhj_table_gather2")
    LAUNCHES["gather2"] += 1
    return out_a, out_b


def radix_histogram_cuda(vals: torch.Tensor,
                         count: Union[int, torch.Tensor],
                         n_bins: int) -> torch.Tensor:
    """int32[n_bins]: histogram of vals[:count] & (n_bins - 1). `count` is
    an int or a 0-d/1-element integer tensor on the same card (read on the
    device: no host sync). n_bins: a power of two, at most
    RADIX_HIST_MAX_BINS."""
    _check("vals", vals)
    n_bins = int(n_bins)
    if (n_bins < 1 or n_bins & (n_bins - 1)
            or n_bins > RADIX_HIST_MAX_BINS):
        raise ValueError(f"n_bins must be a power of two <= "
                         f"{RADIX_HIST_MAX_BINS}, got {n_bins}")
    out = torch.zeros(n_bins, dtype=torch.int32, device=vals.device)
    n = vals.shape[0]
    if n == 0:
        return out
    if isinstance(count, torch.Tensor):
        if count.device != vals.device or count.numel() != 1:
            raise ValueError("count: expected one value on vals' device")
        count_dev = count.reshape(1).to(torch.int32).contiguous()
    else:
        c = max(min(int(count), n), 0)
        count_dev = torch.full((1,), c, dtype=torch.int32,
                               device=vals.device)
    lib = _load("radix")
    sms, stream = _launch_env(vals)
    with torch.cuda.device(vals.device):
        err = lib.rhj_radix_histogram(vals.data_ptr(), n,
                                      count_dev.data_ptr(), out.data_ptr(),
                                      n_bins, sms, stream)
    _raise_on(err, "rhj_radix_histogram")
    LAUNCHES["radix_hist"] += 1
    return out


def rank_hist_cuda(digits: torch.Tensor, n_bins: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ranks int32[n], hists int32[ceil(n / 2048), n_bins]): each digit's
    stable rank among the equal digits of its 2048-element block, and the
    blocks' histograms of digits < n_bins. Digits lie in [0, n_bins]; one
    outside gets rank 0 and is counted nowhere."""
    _check("digits", digits)
    n_bins = int(n_bins)
    if not 1 <= n_bins <= RANK_HIST_MAX_BINS:
        raise ValueError(f"n_bins must be in [1, {RANK_HIST_MAX_BINS}] "
                         f"(one warp's 8-byte cells in a block's 227 KB "
                         f"of shared memory), got "
                         f"{n_bins}")
    n = digits.shape[0]
    n_blocks = -(-n // RANK_BLOCK)
    ranks = torch.empty(n, dtype=torch.int32, device=digits.device)
    hists = torch.empty((n_blocks, n_bins), dtype=torch.int32,
                        device=digits.device)
    if n == 0:
        return ranks, hists
    lib = _load("radix")
    _sms, stream = _launch_env(digits)
    with torch.cuda.device(digits.device):
        err = lib.rhj_rank_hist(digits.data_ptr(), n, n_bins,
                                ranks.data_ptr(), hists.data_ptr(), stream)
    _raise_on(err, "rhj_rank_hist")
    LAUNCHES["rank_hist"] += 1
    return ranks, hists


def select_cuda(rows: Optional[torch.Tensor],
                count: Union[int, torch.Tensor], preds, pad: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int32[pad], 0-d int32): one launch of the conjunctive select.

    The live set is lanes [0, count) of `rows` (padded int32 rowids) or,
    with rows None, of the identity over the columns' common length.
    preds: 1 to SELECT_MAX_PREDS (int32 column, opcode, int32 constant),
    opcodes of ops/filter.py (OP_EQ, OP_LT, OP_GT); a column given twice
    is read once. A live lane survives when every predicate holds on its
    row's value (a rowid outside the column reads the nearest end, an
    empty column 0). Returns the survivors' rowids in lane order, then
    zeros, cut to `pad` lanes, and the number of survivors, on the
    device: `count` (an int, or one int32 value on the same card) is read
    there, and nothing is read back."""
    global SELECT_LAUNCHES
    preds = list(preds)
    if not 1 <= len(preds) <= SELECT_MAX_PREDS:
        raise ValueError(f"select: 1 to {SELECT_MAX_PREDS} predicates, got "
                         f"{len(preds)}")
    cols, pred_col = [], []
    for col, _op, _value in preds:
        _check("col", col)
        at = next((c for c, seen in enumerate(cols)
                   if seen.data_ptr() == col.data_ptr()
                   and seen.shape == col.shape), None)
        if at is None:
            at = len(cols)
            cols.append(col)
        pred_col.append(at)
    device = cols[0].device
    if any(c.device != device for c in cols):
        raise ValueError("select: columns on different devices")
    if rows is None:
        n = cols[0].shape[0]
        if any(c.shape[0] != n for c in cols):
            raise ValueError("select: the identity needs columns of one "
                             "length")
    else:
        _check("rows", rows)
        if rows.device != device:
            raise ValueError("rows/columns: device mismatch")
        n = rows.shape[0]
    if n >= 2**31:
        raise ValueError(f"select: {n} lanes do not fit int32 rowids")
    ops, vals = [], []
    for _col, op, value in preds:
        if op not in (0, 1, 2):
            raise ValueError(f"select: unknown opcode {op}")
        if not -2**31 <= int(value) < 2**31:
            raise ValueError(f"select: constant {value} outside int32")
        ops.append(int(op))
        vals.append(int(value))
    pad = int(pad)
    if pad < 0:
        raise ValueError(f"select: pad {pad} < 0")
    count_dev, host_count = None, 0
    if isinstance(count, torch.Tensor):
        if count.device != device or count.numel() != 1:
            raise ValueError("count: expected one value on the columns' "
                             "device")
        count_dev = count.reshape(1).to(torch.int32).contiguous()
    else:
        host_count = max(min(int(count), n), 0)
    out = torch.empty(pad, dtype=torch.int32, device=device)
    new_count = torch.empty((), dtype=torch.int32, device=device)
    if n == 0:
        out.zero_()
        new_count.zero_()
        return out, new_count
    k = len(cols)
    addrs = (ctypes.c_longlong * k)(*(c.data_ptr() for c in cols))
    lens = (ctypes.c_longlong * k)(*(c.shape[0] for c in cols))
    m = len(preds)
    c_col = (ctypes.c_int * m)(*pred_col)
    c_op = (ctypes.c_int * m)(*ops)
    c_val = (ctypes.c_int * m)(*vals)
    scratch = torch.empty(-(-n // SELECT_TILE) + 1, dtype=torch.int64,
                          device=device)
    lib = _load("select")
    sms, stream = _launch_env(cols[0])
    with torch.cuda.device(device):
        err = lib.rhj_select(
            rows.data_ptr() if rows is not None else None, n,
            count_dev.data_ptr() if count_dev is not None else None,
            host_count, addrs, lens, k, c_col, c_op, c_val, m,
            out.data_ptr(), pad, new_count.data_ptr(), scratch.data_ptr(),
            sms, stream)
    _raise_on(err, "rhj_select")
    SELECT_LAUNCHES += 1
    return out, new_count


def probe_cuda(col: torch.Tensor, rows: torch.Tensor,
               count: Union[int, torch.Tensor], rs: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                          torch.Tensor]:
    """(lo, offsets, cum, total): one launch of the sort join's probe.

    The live left lanes are [0, count) of `rows` (int32 rowids into the
    int32 column `col`, clamped to its ends; an empty column reads 0);
    `count` is an int or one value on the same card, read there. `rs`:
    the sorted int32 right values. Returns int32[len(rows)] lo, offsets
    and cum and a 0-d int32 total, bit for bit what ops/join.py
    probe_count gives on the gathered values (lanes past the count as its
    -1 padding; total -1 past 2**31 - 1 pairs), all on the device:
    nothing is read back."""
    global PROBE_LAUNCHES
    for name, t in (("col", col), ("rows", rows), ("rs", rs)):
        _check(name, t)
    device = rows.device
    if col.device != device or rs.device != device:
        raise ValueError("probe: col, rows and rs on different devices")
    n, r = rows.shape[0], rs.shape[0]
    if not 1 <= n < 2**31 or r >= 2**31:
        raise ValueError(f"probe: {n} left lanes and {r} right values; "
                         f"1 to 2**31 - 1 left lanes, fewer than 2**31 "
                         f"right values")
    count_dev, host_count = None, 0
    if isinstance(count, torch.Tensor):
        if count.device != device or count.numel() != 1:
            raise ValueError("count: expected one value on the rowids' "
                             "device")
        count_dev = count.reshape(1).to(torch.int32).contiguous()
    else:
        host_count = max(min(int(count), n), 0)
    lib = _load("probe")
    # the three outputs as rows of one buffer, each 16-byte aligned
    width = -(-n // 4) * 4
    out = torch.empty((3, width), dtype=torch.int32, device=device)
    lo, offsets, cum = out[0, :n], out[1, :n], out[2, :n]
    total = torch.empty((), dtype=torch.int32, device=device)
    scratch = torch.empty(lib.rhj_probe_scratch_bytes(n, r), dtype=torch.uint8,
                          device=device)
    sms, stream = _launch_env(rows)
    with torch.cuda.device(device):
        err = lib.rhj_probe(
            col.data_ptr(), col.shape[0], rows.data_ptr(), n,
            count_dev.data_ptr() if count_dev is not None else None,
            host_count, rs.data_ptr(), r, lo.data_ptr(), offsets.data_ptr(),
            cum.data_ptr(), total.data_ptr(), scratch.data_ptr(), sms,
            stream)
    _raise_on(err, "rhj_probe")
    PROBE_LAUNCHES += 1
    return lo, offsets, cum, total
