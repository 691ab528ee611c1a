"""Starting and joining the ranks of a distributed run (counterpart:
radixhashjoin_tpu/parallel/multihost.py).

One process per device: `init_multihost` joins this process into the
torch.distributed world, with NCCL for a rank on a CUDA device and gloo
for one on the CPU, and picks its device (cuda:local_rank unless the
caller asks for the CPU). Under torchrun every argument comes from the
environment it sets (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR,
MASTER_PORT). Nothing falls back: a world larger than the visible cards
raises, and so does a failed NCCL initialization.

`run_ranks` and `start_ranks` spawn the ranks of a run on this host
(tests, the CLI's --mesh N): each child joins a world at a free local
port and calls a target with its Mesh; a failing or stuck rank stops
them all.
"""

from __future__ import annotations

import datetime
import os
import queue
import socket
import traceback
from typing import Callable, List, Optional, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from . import mesh as _mesh
from .mesh import make_mesh

# how long a collective may wait for a missing rank before it raises
COLLECTIVE_TIMEOUT_S = 600


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def check_devices(n: int, device: str) -> None:
    """Raise unless n ranks can each have a device of this kind."""
    if device == "cuda":
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n > have:
            raise RuntimeError(f"{n} ranks on cuda need {n} visible cards; "
                               f"this host has {have}")


def init_multihost(coordinator_address: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None, *,
                   device: str = "cuda", local_rank: Optional[int] = None,
                   backend: Optional[str] = None) -> torch.device:
    """Join this process into the world as rank `process_id` of
    `num_processes`, the rendezvous at `coordinator_address` ("host:port"
    or "tcp://host:port"); with no arguments, torchrun's environment.
    `device` is "cuda" (this rank's card, cuda:local_rank) or "cpu", or
    an explicit torch.device. `backend` defaults to nccl on CUDA and gloo
    on the CPU. Returns the rank's device."""
    if coordinator_address is None:
        init_method = "env://"
        num_processes = int(os.environ["WORLD_SIZE"])
        process_id = int(os.environ["RANK"])
        if local_rank is None:
            local_rank = int(os.environ.get("LOCAL_RANK", process_id))
    else:
        host = coordinator_address.split("://")[-1]
        init_method = f"tcp://{host}"
    if local_rank is None:
        local_rank = process_id
    if isinstance(device, torch.device):
        dev = device
    elif device == "cuda":
        check_devices(local_rank + 1, "cuda")
        dev = torch.device("cuda", local_rank)
    elif device == "cpu":
        dev = torch.device("cpu")
    else:
        raise ValueError(f"unsupported device {device!r}")
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    kwargs = {}
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        if backend == "nccl":
            kwargs["device_id"] = dev      # eager init: a failure raises here
    dist.init_process_group(
        backend, init_method=init_method, world_size=num_processes,
        rank=process_id,
        timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S), **kwargs)
    _mesh._DEVICE = dev
    return dev


def shutdown() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()
    _mesh._DEVICE = None


# ---- spawning the ranks of a run on this host ----

def _rank_main(target: Callable, rank: int, n: int, addr: str, device,
               backend, threads: Optional[int], args: Sequence, results):
    """Body of a spawned rank: join, run target(mesh, *args), report."""
    try:
        if threads:
            torch.set_num_threads(threads)
        init_multihost(addr, n, rank, device=device, backend=backend)
        out = target(make_mesh(n), *args)
        results.put((rank, True, out))
    except BaseException:                 # reported to the parent, which
        results.put((rank, False, traceback.format_exc()))   # raises
    finally:
        shutdown()


def start_ranks(target: Callable, n: int, ranks: Sequence[int], addr: str,
                args: Sequence = (), device="cuda", backend=None,
                threads: Optional[int] = None):
    """Spawn the given ranks of an n-rank world at `addr`; each runs
    target(mesh, *args). Returns (processes, result queue)."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = []
    for r in ranks:
        p = ctx.Process(target=_rank_main,
                        args=(target, r, n, addr, device, backend, threads,
                              tuple(args), results), daemon=True)
        p.start()
        procs.append(p)
    return procs, results


def join_ranks(procs, results, expect: int, timeout: float) -> dict:
    """{rank: result} of `expect` ranks; raises on the first rank that
    failed, or when `timeout` seconds pass, and stops every process."""
    got = {}
    deadline = datetime.datetime.now() + datetime.timedelta(seconds=timeout)
    try:
        while len(got) < expect:
            left = (deadline - datetime.datetime.now()).total_seconds()
            if left <= 0:
                raise TimeoutError(f"ranks {sorted(got)} of {expect} "
                                   f"answered in {timeout} s")
            try:
                rank, ok, out = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [p for p in procs
                        if not p.is_alive() and p.exitcode not in (0, None)]
                if dead:
                    raise RuntimeError(f"a rank died with exit code "
                                       f"{dead[0].exitcode}")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{out}")
            got[rank] = out
        for p in procs:
            p.join(timeout=30)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
    return got


def run_ranks(target: Callable, n: int, args: Sequence = (), *,
              device="cuda", backend=None, threads: Optional[int] = None,
              timeout: float = 300) -> List:
    """Run target(mesh, *args) on n spawned ranks of a fresh world; the
    targets' return values (picklable), by rank."""
    addr = f"127.0.0.1:{free_port()}"
    procs, results = start_ranks(target, n, range(n), addr, args, device,
                                 backend, threads)
    got = join_ranks(procs, results, n, timeout)
    return [got[r] for r in range(n)]
