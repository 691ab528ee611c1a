"""Build and bind the hand-written Hopper kernels (csrc/tables.cu).

The source compiles with nvcc into a shared library with a plain C
interface (no PyTorch headers, so the build takes seconds), at first
use, into `build/` beside this file. The library's name carries a hash
of the source, so an edited source never loads a stale build. Nothing
here runs at import time: the CPU tests import this module on machines
with no nvcc and no card.

A missing nvcc, a failed build, a refused launch or a wrong operand
raises. There is no fallback: ops/tables.py sends only CUDA tensors here,
and a CUDA tensor either runs the kernel or fails.

`LAUNCHES` counts kernel launches per wrapper ("bincount", "gather"),
so a run can show that its main path went through these kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

import torch

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_PKG_DIR, "csrc", "tables.cu")
BUILD_DIR = os.path.join(_PKG_DIR, "build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]
NVCC_FALLBACK = "/usr/local/cuda/bin/nvcc"

LAUNCHES = {"bincount": 0, "gather": 0}

_lib = None


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
        f" the CUDA kernels of csrc/tables.cu cannot be built")


def library_path() -> str:
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libtables_{digest.hexdigest()[:12]}.so")


def build() -> dict:
    """Compile csrc/tables.cu unless this source's library exists.
    Returns {"path", "seconds", "log"}; "seconds" is 0.0 when the build
    was already there. Raises on any failure."""
    path = library_path()
    if os.path.exists(path):
        return {"path": path, "seconds": 0.0, "log": ""}
    nvcc = find_nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", tmp, SOURCE],
                          capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed (exit {proc.returncode}):\n{log}")
    os.replace(tmp, path)       # atomic: a concurrent build never sees half
    return {"path": path, "seconds": seconds, "log": log}


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build()["path"])
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.rhj_weighted_bincount.argtypes = [ptr, ptr, i64, ptr, i32, i32,
                                              ptr]
        lib.rhj_weighted_bincount.restype = i32
        lib.rhj_table_gather.argtypes = [ptr, i32, ptr, i64, ptr, i32, ptr]
        lib.rhj_table_gather.restype = i32
        _lib = lib
    return _lib


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
                           n_bins: int) -> torch.Tensor:
    """int32[n_bins]: out[b] = sum of weights[i] over idxs[i] == b, indices
    outside [0, n_bins) dropped. Caller contract: weights >= 0 and every
    per-bin total < 2**31."""
    _check("idxs", idxs)
    _check("weights", weights)
    if weights.shape != idxs.shape or weights.device != idxs.device:
        raise ValueError("idxs/weights: shape or device mismatch")
    n_bins = int(n_bins)
    if not 0 <= n_bins < 2**31:
        raise ValueError(f"n_bins out of range: {n_bins}")
    out = torch.zeros(n_bins, dtype=torch.int32, device=idxs.device)
    n = idxs.shape[0]
    if n == 0 or n_bins == 0:
        return out
    lib = _load()
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
    """int32[n]: table[keys[i]] where 0 <= keys[i] < len(table), else 0."""
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
    out = torch.empty(n, dtype=torch.int32, device=keys.device)
    lib = _load()
    sms, stream = _launch_env(keys)
    with torch.cuda.device(keys.device):
        err = lib.rhj_table_gather(table.data_ptr(), n_bins, keys.data_ptr(),
                                   n, out.data_ptr(), sms, stream)
    _raise_on(err, "rhj_table_gather")
    LAUNCHES["gather"] += 1
    return out
