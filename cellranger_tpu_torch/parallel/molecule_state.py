"""Device-resident molecule accumulator for count-only runs (one device).

Port of cellranger_tpu/parallel/executor.py `_absorb_append`,
`_dedup_state` and `MoleculeState`.  The accumulate-mode step keeps its
confidently mapped (bc, gene, umi) rows on the device; `MoleculeState`
keeps them there through dedup: each drained append buffer is appended
(not merged) to a persistent [C, 4] state of u32 values (bc, gene, umi,
reads), `exact_merge` reclaims the space that duplicate triples waste
only under capacity pressure and once at finalize, and the final dedup
runs on the state.  The only host traffic is the final fetch of the
valid molecules.

The state is updated in place (index_copy_ into a preallocated buffer),
which takes the place of the JAX package's buffer donation.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.dedup import dedup_molecules, exact_merge
from ..ops.tensor_ops import U32_MAX, lexsort


def _pow2(n: int, minimum: int = 1024) -> int:
    p = minimum
    while p < n:
        p *= 2
    return p


def _absorb_append(state_rows, state_n, mol, mol_n):
    """Write a drained [P, 3] buffer (live rows [0, mol_n)) into the
    [C, 4] state at row state_n as weight-1 rows, without merging;
    dead rows are written as sentinels.  Returns the new device count.
    The caller guarantees state_n + P <= C."""
    P = mol.shape[0]
    dev = mol.device
    live = torch.arange(P, device=dev) < mol_n
    new_rows = torch.cat(
        [torch.where(live[:, None], mol, U32_MAX), live[:, None].to(
            torch.int64)], 1)
    state_rows.index_copy_(0, state_n + torch.arange(P, device=dev),
                           new_rows)
    return state_n + mol_n


def _dedup_state(rows, n, umi_len: int):
    """Final dedup of the merged state: valid molecules first.  Returns
    ([C, 4] (bc, gene, umi, reads) u32 values, n_valid)."""
    C = rows.shape[0]
    live = torch.arange(C, device=rows.device) < n
    dd = dedup_molecules(rows[:, 0], rows[:, 1], rows[:, 2], live,
                         umi_len, reads=rows[:, 3])
    inval = (~dd["mol_valid"]).to(torch.int64)
    o = lexsort(inval)
    plane = torch.stack([dd["mol_bc"][o], dd["mol_gene"][o],
                         dd["mol_umi"][o], dd["mol_reads"][o]], 1)
    return plane, dd["mol_valid"].sum()


class MoleculeState:
    """Host handle on the device-resident merged molecule table.

    Capacity grows geometrically (pow2 up to max_capacity).  Runs whose
    distinct triples exceed max_capacity would need the host flush path
    of the JAX package, which the port does not have yet."""

    def __init__(self, max_capacity: int, umi_len: int, device,
                 min_capacity: int = 1024):
        self.max_cap = max_capacity
        self.umi_len = umi_len
        self.device = torch.device(device)
        self.cap = min_capacity
        self.rows = torch.full((self.cap, 4), U32_MAX, dtype=torch.int64,
                               device=self.device)
        self._n_dev = torch.zeros((), dtype=torch.int64, device=self.device)
        self.n = 0          # host UPPER BOUND on live rows (see absorb)

    def _grow(self, need: int) -> None:
        cap = _pow2(need, minimum=self.cap)
        if cap == self.cap:
            return
        self.rows = torch.cat(
            [self.rows, torch.full((cap - self.cap, 4), U32_MAX,
                                   dtype=torch.int64, device=self.device)])
        self.cap = cap

    def absorb(self, mol: torch.Tensor, mol_n: torch.Tensor,
               upper: int) -> None:
        """Append a drained device [B, 3] buffer; `upper` is the
        host-known bound on mol_n.  Non-blocking: the host tracks only the
        additive upper bound, so no device count is fetched unless the
        bound says capacity is short."""
        P = _pow2(max(min(upper, int(mol.shape[0])), 1), minimum=1024)
        if self.n + P > self.max_cap:
            self.merge_now()             # compact + tighten the bound
            if self.n + P > self.max_cap:
                raise NotImplementedError(
                    "more than max_capacity distinct (bc, gene, umi) "
                    "triples: the host flush path of the molecule state "
                    "is not ported yet (ROADMAP queue 1)")
        self._grow(self.n + P)
        if self.n + P > self.cap:
            raise RuntimeError("molecule state append window out of bounds")
        self._n_dev = _absorb_append(self.rows, self._n_dev, mol[:P], mol_n)
        self.n = min(self.n + int(upper), self.cap)

    def merge_now(self) -> None:
        """Exact-merge duplicate triples in place and tighten the host
        bound to the exact merged count (one scalar fetch)."""
        self.rows, self._n_dev = exact_merge(self.rows, self._n_dev)
        self.n = int(self._n_dev)

    def finalize(self):
        """-> (bc, gene, umi, reads) uint32 host arrays of the valid
        molecules.  Shrinks to the tightest pow2 over the live rows,
        exact-merges once, shrinks again, then dedups."""
        self.n = int(self._n_dev)
        C2 = _pow2(max(self.n, 1), minimum=1024)
        rows = self.rows[:C2] if C2 < self.cap else self.rows
        rows, n_dev = exact_merge(rows, self._n_dev)
        self.n = int(n_dev)
        C3 = _pow2(max(self.n, 1), minimum=1024)
        if C3 < C2:
            rows = rows[:C3]
        plane, n_valid = _dedup_state(rows, n_dev, self.umi_len)
        self.rows = None
        nv = int(n_valid)
        out = plane[:nv].cpu().numpy().astype(np.uint32)
        return out[:, 0], out[:, 1], out[:, 2], out[:, 3]
