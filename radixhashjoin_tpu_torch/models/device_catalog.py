"""Device-resident column catalog (counterpart:
radixhashjoin_tpu/models/device_catalog.py).

Columns upload once, to the device the Engine names, and every query
reuses them. The encoding is the reference's, array for array:

* join/filter columns are int32 device codes — the values themselves
  when every column fits int32 (identity encoding), else codes into one
  order-preserving global dictionary of the catalog's u64 values
  (`_build_dictionary`), so equality and order of codes are those of
  the values and filter constants translate exactly (`encode_filter`);
* a projected column is summed as planes (`proj_planes`): the values
  when they fit int32, else 16-bit slices combined on the host with
  shifts mod 2**64; a relation of more than _NARROW_PLANE_MIN_ROWS rows
  stores a plane whose values fit 16 bits as uint16 (half the bytes,
  and the factorized wave's folds read it zero-extended), while the
  materialized paths, which look planes up by row id, take int32 copies
  (`int32_planes`);
* composite (multi-column) tree-edge keys get shared pair codes
  (`edge_key`), and a pristine leaf's message table comes precomputed
  (`bincount_table`, `edge_bincount`).

Row sharding (the distributed executor, parallel/dist_executor.py): with
a `mesh`, every per-row array (join/filter columns, projection planes,
composite edge keys) holds only this rank's rows. Rank r owns global
rowids [r * cap, (r + 1) * cap) of a relation, cap = `shard_cap(rel)` =
bucket(ceil(rows / ranks)), zero-padded past the relation's end, so each
rank holds ~1/N of the catalog; domain-sized tables (bincounts, the
dictionary) and scalars stay whole on every rank. A row-sharded catalog
stores no uint16 planes, as in the reference (its :180).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import DEFAULT, EngineConfig
from ..ops.filter import OP_CODE
from ..storage import Relation, small_value_counts
from ..utils.padding import bucket_size

# Values the identity (no-dictionary) encoding can represent (the
# reference keeps INT32_MAX free as its join sentinel).
NARROW_MAX = 2**31 - 2

_INT32_MAX = 2**31 - 1

# Projection planes of relations above this many rows store as uint16
# when their values fit 16 bits: at 2**29 rows an int32 plane takes 2 GB,
# a uint16 one 1 GB. Read at call time so that tests can shrink it.
_NARROW_PLANE_MIN_ROWS = 1 << 28

_UPLOAD_DTYPES = (np.int32, np.uint16)


def resolve_device(device) -> torch.device:
    """The device a run asked for; a CUDA device without a card raises
    (never a silent CPU)."""
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA device requested but torch.cuda.is_available() is "
                "False (run on device 'cpu', --device cpu on the command "
                "line, for the plain PyTorch versions)")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class DeviceCatalog:
    def __init__(self, relations: Sequence[Relation],
                 config: EngineConfig = DEFAULT, *,
                 device: Optional[torch.device] = None, mesh=None):
        """`device` (default: the card, resolve_device("cuda")) holds the
        columns; with a `mesh`, the mesh's device."""
        self.relations = relations
        self.config = config
        self.mesh = mesh
        self.device = (torch.device(mesh.device) if mesh is not None
                       else resolve_device("cuda" if device is None
                                           else device))
        self._cols: Dict[tuple, torch.Tensor] = {}
        self._planes: Dict[tuple, list] = {}
        self._wide_planes: Dict[tuple, list] = {}
        self._edge_keys: Dict[tuple, tuple] = {}
        self._edge_mults: Dict[tuple, int] = {}
        self._edge_bincounts: Dict[tuple, torch.Tensor] = {}
        self._max_mult: Dict[tuple, int] = {}
        self._bincounts: Dict[tuple, torch.Tensor] = {}
        self._iota: Dict[int, torch.Tensor] = {}
        self._scalars: Dict[int, torch.Tensor] = {}
        self._placeholders: Dict[int, torch.Tensor] = {}
        self._domain: Optional[int] = None
        # order-preserving global dictionary (only if any column is
        # wide); None => identity encoding (codes are the values)
        self.dict_vals: Optional[np.ndarray] = None
        if any(s.max > NARROW_MAX for rel in relations for s in rel.stats):
            self._build_dictionary()

    def _put(self, host: np.ndarray) -> torch.Tensor:
        """Upload one int32 (or uint16 plane) host array to the catalog's
        device."""
        if host.dtype not in _UPLOAD_DTYPES:
            raise TypeError(f"catalog uploads int32 and uint16 only, got "
                            f"{host.dtype}")
        return torch.from_numpy(np.ascontiguousarray(host)).to(self.device)

    def shard_cap(self, rel_id: int) -> int:
        """Rows of a relation each rank holds under row sharding:
        bucket(ceil(rows / ranks)). Live sets use the same capacity, so a
        rank's live rowids index its own column shards."""
        rows = self.relations[rel_id].num_tuples
        return self.bucket(-(-rows // self.mesh.size))

    def _put_rows(self, rel_id: int, host: np.ndarray) -> torch.Tensor:
        """Upload a per-row array of relation rel_id: whole, or this rank's
        zero-padded shard of it under row sharding."""
        if self.mesh is None:
            return self._put(host)
        cap = self.shard_cap(rel_id)
        part = host[self.mesh.rank * cap:(self.mesh.rank + 1) * cap]
        if len(part) < cap:
            part = np.pad(part, (0, cap - len(part)))
        return self._put(part)

    # ---- dictionary ----

    def _build_dictionary(self) -> None:
        uniques = [np.unique(col) for rel in self.relations
                   for col in rel.values if len(col)]
        dv = (np.unique(np.concatenate(uniques)) if uniques
              else np.zeros(0, np.uint64))
        if len(dv) > NARROW_MAX:
            raise ValueError(
                f"catalog has {len(dv)} distinct values; the int32 code "
                f"space caps at {NARROW_MAX}")
        self.dict_vals = dv

    def _host_codes(self, rel_id: int, col: int) -> np.ndarray:
        if self.dict_vals is None:
            return self.relations[rel_id].narrow_column(col)
        return np.searchsorted(
            self.dict_vals,
            self.relations[rel_id].values[col]).astype(np.int32)

    def col(self, rel_id: int, col: int) -> torch.Tensor:
        """Join/filter column on device: int32 values (identity) or codes."""
        key = (rel_id, col)
        if key not in self._cols:
            self._cols[key] = self._put_rows(rel_id,
                                             self._host_codes(rel_id, col))
            if (self.dict_vals is None and key in self._planes
                    and self._planes[key][0][0].dtype == torch.uint16):
                # a projection uploaded a uint16 plane before a join or
                # filter needed the int32 column: the plane becomes the
                # column (the same values), so the column is not resident
                # twice
                self._planes[key] = [(self._cols[key], 0)]
        return self._cols[key]

    def encode_filter(self, op: str, value: int) -> Tuple[int, int]:
        """Map a filter (op, u64 constant) onto the device code space:
        (opcode, int32-range constant) such that the strict comparison on
        device codes selects exactly the rows whose original value
        satisfies the original predicate (Query.cpp:91-146 semantics)."""
        opc = OP_CODE[op]
        if self.dict_vals is None:
            if value <= _INT32_MAX - 1:
                return opc, int(value)
            if op == "=":
                return opc, -1                     # no narrow value matches
            return opc, _INT32_MAX                 # < huge: all; > huge: none
        dv = self.dict_vals
        v = np.uint64(min(value, 2**64 - 1))
        lb = int(np.searchsorted(dv, v, side="left"))
        if op == "=":
            present = lb < len(dv) and dv[lb] == v
            return opc, (lb if present else -1)
        if op == "<":
            return opc, lb                         # value < K <=> code < lb
        rb = int(np.searchsorted(dv, v, side="right"))
        return opc, rb - 1                         # value > K <=> code > rb-1

    def proj_planes(self, rel_id: int, col: int
                    ) -> List[Tuple[torch.Tensor, int]]:
        """[(device plane, shift)] whose shifted sums add up to the exact
        u64 SUM of the original column: one plane of the values when they
        fit int32, else 16-bit slices. Planes are int32, or uint16 on a
        relation of more than _NARROW_PLANE_MIN_ROWS rows where the
        plane's values fit 16 bits (never under row sharding)."""
        key = (rel_id, col)
        if key not in self._planes:
            rel = self.relations[rel_id]
            huge = (self.mesh is None
                    and rel.num_tuples > _NARROW_PLANE_MIN_ROWS)
            narrow = huge and rel.stats[col].max < (1 << 16)
            if self.dict_vals is None:
                if narrow and key not in self._cols:
                    # a uint16 copy only while no join or filter holds the
                    # int32 column (col() re-aliases the plane if one
                    # comes later); else the column itself costs nothing
                    self._planes[key] = [(self._put_rows(
                        rel_id, rel.values[col].astype(np.uint16)), 0)]
                else:
                    # identity encoding: the join/filter column IS the
                    # values
                    self._planes[key] = [(self.col(rel_id, col), 0)]
            elif rel.stats[col].max <= _INT32_MAX:
                dt = np.uint16 if narrow else np.int32
                self._planes[key] = [(self._put_rows(
                    rel_id, rel.values[col].astype(dt)), 0)]
            else:
                host = rel.values[col]
                hi = int(rel.stats[col].max).bit_length()
                dt = np.uint16 if huge else np.int32
                planes = []
                for shift in range(0, hi, 16):
                    p = ((host >> np.uint64(shift))
                         & np.uint64(0xFFFF)).astype(dt)
                    planes.append((self._put_rows(rel_id, p), shift))
                self._planes[key] = planes
        return self._planes[key]

    def int32_planes(self, rel_id: int, col: int
                     ) -> List[Tuple[torch.Tensor, int]]:
        """proj_planes with every uint16 plane as int32 (cached): the
        materialized paths look planes up by row id, and PyTorch's
        index_select has no uint16 kernel."""
        planes = self.proj_planes(rel_id, col)
        if all(p.dtype == torch.int32 for p, _s in planes):
            return planes
        if self.dict_vals is None:
            return [(self.col(rel_id, col), 0)]      # re-aliases the plane
        key = (rel_id, col)
        if key not in self._wide_planes:
            self._wide_planes[key] = [(p.to(torch.int32), s)
                                      for p, s in planes]
        return self._wide_planes[key]

    # ---- composite (tuple) join keys ----
    #
    # A case-3 predicate paralleling an existing tree edge fuses into it
    # as a COMPOSITE key (models/batch.py:_extract_tree): the pair (a, b)
    # joins equal iff a pair code does, under a dictionary shared by both
    # relations (host-built once and cached).

    def _edge_key_host(self, rel_p: int, pcols: tuple, rel_c: int,
                       ccols: tuple):
        """(pcodes, ccodes) under one shared dense encoding."""
        pk = self._host_codes(rel_p, pcols[0]).astype(np.int64)
        ck = self._host_codes(rel_c, ccols[0]).astype(np.int64)
        for pc, cc in zip(pcols[1:], ccols[1:]):
            pk = (pk << 32) | self._host_codes(rel_p, pc)
            ck = (ck << 32) | self._host_codes(rel_c, cc)
            shared = np.unique(np.concatenate([pk, ck]))
            pk = np.searchsorted(shared, pk)
            ck = np.searchsorted(shared, ck)
        return pk.astype(np.int32), ck.astype(np.int32)

    def edge_key(self, rel_p: int, pcols: tuple, rel_c: int, ccols: tuple):
        """Device key columns of a (possibly composite) tree edge:
        (pkey, ckey, code_max)."""
        if len(pcols) == 1:
            return (self.col(rel_p, pcols[0]), self.col(rel_c, ccols[0]),
                    max(self.code_max(rel_p, pcols[0]),
                        self.code_max(rel_c, ccols[0])))
        key = (rel_p, pcols, rel_c, ccols)
        if key not in self._edge_keys:
            pk, ck = self._edge_key_host(rel_p, pcols, rel_c, ccols)
            cmax = int(max(pk.max(initial=0), ck.max(initial=0)))
            self._edge_keys[key] = (self._put_rows(rel_p, pk),
                                    self._put_rows(rel_c, ck), cmax)
        return self._edge_keys[key]

    def edge_key_max_mult(self, rel_p: int, pcols: tuple, rel_c: int,
                          ccols: tuple, side: str) -> int:
        """Max multiplicity of the edge key within one side's relation —
        the composite analog of max_mult for the planner's caps."""
        if len(pcols) == 1:
            rel, col = ((rel_p, pcols[0]) if side == "p"
                        else (rel_c, ccols[0]))
            return self.max_mult(rel, col)
        key = (rel_p, pcols, rel_c, ccols, side)
        if key not in self._edge_mults:
            pk, ck = self._edge_key_host(rel_p, pcols, rel_c, ccols)
            codes = pk if side == "p" else ck
            if len(codes) == 0:
                self._edge_mults[key] = 1
            else:
                _, counts = np.unique(codes, return_counts=True)
                self._edge_mults[key] = int(counts.max())
        return self._edge_mults[key]

    def edge_bincount(self, rel_p: int, pcols: tuple, rel_c: int,
                      ccols: tuple, width: int) -> torch.Tensor:
        """Precomputed child-side key bincount for a pristine leaf of a
        composite edge (width-sized)."""
        key = (rel_p, pcols, rel_c, ccols, width)
        if key not in self._edge_bincounts:
            _, ck = self._edge_key_host(rel_p, pcols, rel_c, ccols)
            t = np.bincount(ck, minlength=width).astype(np.int32)
            self._edge_bincounts[key] = self._put(t)
        return self._edge_bincounts[key]

    def code_max(self, rel_id: int, col: int) -> int:
        """Max device code of a column (the value max under the identity
        encoding, else that max's dictionary code): drives the planner's
        per-edge message-table widths."""
        s = self.relations[rel_id].stats[col]
        if self.dict_vals is None:
            return int(s.max)
        return int(np.searchsorted(self.dict_vals, np.uint64(s.max)))

    def max_mult(self, rel_id: int, col: int) -> int:
        """Exact max multiplicity of any value in the column (host scan,
        cached) — filters only shrink it, so it bounds every query."""
        key = (rel_id, col)
        if key not in self._max_mult:
            vals = self.relations[rel_id].values[col]
            if len(vals) == 0:
                self._max_mult[key] = 1
            else:
                # one O(n) bincount where the values allow it (the
                # 2**29-row facts), else np.unique's sort
                counts = small_value_counts(
                    vals, self.relations[rel_id].stats[col].max)
                if counts is None:
                    _, counts = np.unique(vals, return_counts=True)
                self._max_mult[key] = int(counts.max())
        return self._max_mult[key]

    def plane_maxes(self, rel_id: int, col: int) -> List[int]:
        """Max value per projection plane, aligned with proj_planes."""
        planes = self.proj_planes(rel_id, col)
        s = self.relations[rel_id].stats[col]
        if len(planes) == 1 and planes[0][1] == 0 and s.max <= _INT32_MAX:
            return [int(s.max)]
        return [0xFFFF] * len(planes)

    def bincount_table(self, rel_id: int, col: int) -> torch.Tensor:
        """int32[domain] bincount of the column's device codes: the
        query-independent message table of a pristine leaf. Built once
        per (relation, column) on the host at first use."""
        key = (rel_id, col)
        if key not in self._bincounts:
            codes = self._host_codes(rel_id, col)
            t = np.bincount(codes, minlength=self.domain).astype(np.int32)
            self._bincounts[key] = self._put(t)
        return self._bincounts[key]

    def iota(self, size: int) -> torch.Tensor:
        """Cached int32 arange(size) on the device: the identity rowid set
        of a pristine slot."""
        if size not in self._iota:
            self._iota[size] = torch.arange(size, dtype=torch.int32,
                                            device=self.device)
        return self._iota[size]

    def scalar(self, value: int) -> torch.Tensor:
        """Cached 0-d int32 device tensor: the wave-batched path's live
        counts stay on the device, and an upload (a host-to-device copy,
        which synchronizes the host) happens once per value per catalog,
        not once per run."""
        v = int(value)
        if v not in self._scalars:
            self._scalars[v] = torch.tensor(v, dtype=torch.int32,
                                            device=self.device)
        return self._scalars[v]

    def mat_placeholder(self, width: int) -> torch.Tensor:
        """Cached all-zero (1, width) int32 matrix: the stage runner's
        intermediate for a query that has none yet."""
        if width not in self._placeholders:
            self._placeholders[width] = torch.zeros(
                (1, width), dtype=torch.int32, device=self.device)
        return self._placeholders[width]

    def bucket(self, n: int) -> int:
        return bucket_size(n, self.config.min_pad, self.config.pad_base)

    @property
    def domain(self) -> int:
        """Power-of-two bound (>= 1024) above every device code."""
        if self._domain is None:
            if self.dict_vals is not None:
                gmax = len(self.dict_vals) - 1
            else:
                gmax = 0
                for rel in self.relations:
                    for s in rel.stats:
                        gmax = max(gmax, s.max)
            d = 1024
            while d <= gmax + 1:
                d *= 2
            self._domain = d
        return self._domain
