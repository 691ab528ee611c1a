"""The ranks of a distributed run (counterpart: radixhashjoin_tpu/parallel/
mesh.py).

The reference runs one controller over a JAX device mesh; the port runs
one process per device under torch.distributed (NCCL on CUDA, gloo on
the CPU), each with its own shard, and a `Mesh` is what one rank knows
of the run: its rank, the world size, its device, and the collectives
of the distributed layer over the world's process group. Every rank
issues the same collectives in the same order: the host programs are
identical, and every value read back to steer them has been made global
first (all_reduce / all_gather).

`calls` counts the collectives issued, by kind, so that a run can show
how many a query took.

`all_to_all` and `all_gather` take `async_op=True`: they then return a
`Pending` whose `wait()` gives the received tensor, so a caller can
compute while the collective is in flight (the pipelined chunk loops of
dist_ops.py). On NCCL the collective runs on the process group's own
stream and `wait()` makes the current stream wait for it (no host
block); on gloo `wait()` blocks the host until the collective is done.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.distributed as dist

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
        "min": dist.ReduceOp.MIN}


class Pending:
    """An issued collective. `wait()` (once) gives its result. The
    handle holds the collective's input and output tensors until then:
    the caching allocator must not hand their memory to the compute
    stream while the collective may still read or write it, whichever
    way the process group tracks them (record_stream, or stashing them
    in its work object under TORCH_NCCL_AVOID_RECORD_STREAMS). After
    `wait()` the current stream is ordered after the collective, so
    freeing them there is safe. A failed collective raises here."""

    def __init__(self, work, result, keep):
        self._work = work
        self._result = result
        self._keep = keep

    def wait(self) -> torch.Tensor:
        self._work.wait()
        out = self._result()
        self._keep = self._result = None
        return out


class Mesh:
    """One rank's view of a 1-D world of `size` ranks."""

    def __init__(self, rank: int, size: int, device: torch.device,
                 group=None):
        self.rank = rank
        self.size = size
        self.device = torch.device(device)
        self.group = group            # None: the default (world) group
        self.calls: Dict[str, int] = {"all_reduce": 0, "all_to_all": 0,
                                      "all_gather": 0, "broadcast": 0}

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """In place over the ranks; returns t. int64 sums wrap mod 2**64
        (two's complement), as the exact folds need."""
        self.calls["all_reduce"] += 1
        dist.all_reduce(t, op=_OPS[op], group=self.group)
        return t

    def all_to_all(self, t: torch.Tensor, async_op: bool = False):
        """Row block d of t (dim 0 split evenly in `size`) goes to rank d;
        row block s of the result came from rank s. With async_op, a
        Pending of that result."""
        self.calls["all_to_all"] += 1
        t = t.contiguous()
        out = torch.empty_like(t)
        work = dist.all_to_all_single(out, t, group=self.group,
                                      async_op=True)
        pending = Pending(work, lambda: out, (t, out))
        return pending if async_op else pending.wait()

    def all_gather(self, t: torch.Tensor, async_op: bool = False):
        """(size, *t.shape): every rank's t, by rank. With async_op, a
        Pending of that result."""
        self.calls["all_gather"] += 1
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(self.size)]
        work = dist.all_gather(parts, t, group=self.group, async_op=True)
        pending = Pending(work, lambda: torch.stack(parts), (t, parts))
        return pending if async_op else pending.wait()

    def broadcast_object(self, obj, src: int = 0):
        """A picklable host object from rank `src` to every rank."""
        self.calls["broadcast"] += 1
        box = [obj]
        dist.broadcast_object_list(box, src=src, group=self.group,
                                   device=(self.device if
                                           self.device.type == "cuda"
                                           else None))
        return box[0]


_DEVICE: Optional[torch.device] = None     # set by multihost.init_multihost


def make_mesh(n_devices: Optional[int] = None,
              device: Optional[torch.device] = None) -> Mesh:
    """This rank's Mesh over the initialized world. `n_devices` must equal
    the world size when given: a run never truncates to fewer ranks nor
    pretends to more (the reference's rule, parallel/mesh.py:20-30).
    `device` defaults to the one init_multihost chose for this rank."""
    if not dist.is_initialized():
        raise RuntimeError(
            "no torch.distributed process group: start the ranks with "
            "`python -m radixhashjoin_tpu_torch --mesh N` or torchrun, or "
            "call parallel.multihost.init_multihost first")
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"requested a {n_devices}-rank mesh in a world of "
                         f"{world} ranks; start exactly {n_devices} ranks")
    dev = device if device is not None else _DEVICE
    if dev is None:
        raise RuntimeError("this rank has no device: init_multihost picks "
                           "one, or pass device=")
    return Mesh(dist.get_rank(), world, dev)
