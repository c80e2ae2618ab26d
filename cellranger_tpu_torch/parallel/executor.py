"""Execution context: one object that hides one device against a mesh.

Port of cellranger_tpu/parallel/executor.py `Executor` and the dedup
plane packing (the device-resident molecule state and the single-device
partition dedup live in molecule_state.py).  `run_count` builds an
Executor once; whether a batch runs on one device or over the devices of
a `Mesh` is decided here: batches split over the mesh, the index is
replicated per distinct device, metric vectors are summed, and the
partition dedup fans out one barcode-hash partition per device.
"""

from __future__ import annotations

import numpy as np
import torch

from .mesh import Mesh, make_sharded_part_dedup, make_sharded_step, split
from .molecule_state import DD_U32, _compact, _pow2
from .molecule_state import dedup_partitions as _dedup_partitions_one

# dedup output packing: one [N, 12] int32 plane per call, u32 columns as
# their int32 bits; runs without BAM or Feature Barcode consumers need
# only the five molecule columns
DD_FIELDS = ("mol_bc", "mol_gene", "mol_umi", "mol_reads", "mol_valid",
             "raw_bc", "raw_gene", "raw_umi", "raw_corr_umi", "raw_low",
             "raw_is_repr", "raw_reads")
DD_FIELDS_MOL = DD_FIELDS[:5]


def _pack_dd(dd: dict, fields) -> torch.Tensor:
    """Dedup outputs -> one [N, len(fields)] int32 plane (int64 u32 values
    keep their low 32 bits)."""
    return torch.stack([dd[k].to(torch.int64).to(torch.int32)
                        for k in fields], 1)


def _unpack_dd(plane: np.ndarray) -> dict:
    fields = DD_FIELDS if plane.shape[1] == len(DD_FIELDS) else DD_FIELDS_MOL
    out = {}
    for j, k in enumerate(fields):
        col = plane[:, j]
        out[k] = col.view(np.uint32) if k in DD_U32 else col
    return out


class Executor:
    """One device or a mesh for the counting hot path."""

    def __init__(self, mesh: Mesh | None, device):
        if mesh is not None and mesh.size == 1:
            mesh = None  # degenerate mesh: the plain single-device path
        self.mesh = mesh
        self.device = torch.device(device)
        self.n_devices = mesh.size if mesh is not None else 1

    def round_batch(self, batch_size: int) -> int:
        """Round the batch size up so it splits evenly across devices."""
        n = self.n_devices
        return -(-batch_size // n) * n

    def put(self, a: np.ndarray):
        """A host array onto the device, or onto the mesh as N dim-0
        slices; uint32 arrays travel as their int32 bits."""
        if self.mesh is not None:
            return split(self.mesh, a)
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        return torch.from_numpy(a).to(self.device)

    def wrap_step(self, step_for_device):
        """step_for_device(device) -> step; on a mesh, the data-parallel
        step over per-device replicas (`make_sharded_step`)."""
        if self.mesh is None:
            return step_for_device(self.device)
        return make_sharded_step(step_for_device, self.mesh)

    def dedup_partitions(self, parts, umi_len: int, keep_raw: bool = True,
                         chunk_limit: int = 1 << 21):
        """Dedup barcode-disjoint molecule partitions; yields one host
        dict per partition group of at most chunk_limit rows (see
        molecule_state.dedup_partitions).
        On a mesh, n_devices partitions run per call, partition d on
        devices[d], each padded to one common power-of-two length (dedup
        is pad-invariant: invalid rows carry sentinel keys); the raw-
        triple views always come back."""
        if self.mesh is None:
            yield from _dedup_partitions_one(parts, umi_len, self.device,
                                             chunk_limit=chunk_limit,
                                             keep_raw=keep_raw)
            return
        parts = list(parts)
        n = self.n_devices
        dedup = make_sharded_part_dedup(self.mesh, umi_len)
        for i in range(0, len(parts), n):
            group = parts[i:i + n]
            real = len(group)
            group += [(np.zeros(0, np.uint32),) * 3] * (n - real)
            N = _pow2(max(max(len(g[0]) for g in group), 1))
            stack = np.zeros((3, n, N), np.int64)
            valid = np.zeros((n, N), bool)
            for d, (bc, gene, umi) in enumerate(group):
                for c, col in enumerate((bc, gene, umi)):
                    stack[c, d, :len(col)] = col
                valid[d, :len(bc)] = True
            plane = dedup(*(self.put(stack[c].reshape(-1)) for c in range(3)),
                          self.put(valid.reshape(-1)))
            host = plane.cpu().numpy().reshape(n, N, len(DD_FIELDS))
            for d in range(real):
                yield _compact(_unpack_dd(host[d]))
