"""Small tensor helpers shared by the device code of the port.

Conventions: torch has no usable uint32 arithmetic, so a u32 value lives
in an int64 tensor with its value in [0, 2**32); `U32_MASK` re-wraps the
result of +, -, * or << the way uint32 arithmetic would.  Tables stored
on the device keep their u32 bits in int32 tensors (`u32_table`), which
keeps them at the JAX package's size; `widen` turns a gather from such a
table back into u32 values.
"""

from __future__ import annotations

import numpy as np
import torch

U32_MASK = 0xFFFFFFFF
U32_MAX = 0xFFFFFFFF  # sentinel key: sorts after every real u32 key


def u32_table(a: np.ndarray, device) -> torch.Tensor:
    """numpy uint32 array -> int32 tensor holding the same bits."""
    a = np.ascontiguousarray(np.asarray(a, np.uint32))
    return torch.from_numpy(a.view(np.int32).copy()).to(device)


def widen(x: torch.Tensor) -> torch.Tensor:
    """int32 bit-view of u32 values -> int64 u32 values."""
    return x.to(torch.int64) & U32_MASK


def compact_indices(mask: torch.Tensor, size: int, fill: int) -> torch.Tensor:
    """Indices of the True entries of a 1-D mask, in order, truncated or
    padded with `fill` to exactly `size` entries (jnp.nonzero(mask,
    size=size, fill_value=fill)), without a host sync."""
    n = mask.shape[0]
    rank = torch.cumsum(mask.to(torch.int64), 0) - 1
    dest = torch.where(mask & (rank < size), rank, size)
    out = torch.full((size + 1,), fill, dtype=torch.int64, device=mask.device)
    # rows that do not fit all land in the scratch slot `size`
    out.scatter_(0, dest, torch.arange(n, device=mask.device))
    return out[:size]


def scatter_drop(init: torch.Tensor, idx: torch.Tensor,
                 vals: torch.Tensor) -> torch.Tensor:
    """init.at[idx].set(vals, mode="drop") for idx in [0, len(init)]: the
    index len(init) (a compaction's fill) writes a scratch row that is
    sliced off.  Returns a new tensor."""
    n = init.shape[0]
    buf = torch.cat([init, init[:1]], 0)
    buf[idx] = vals.to(buf.dtype)
    return buf[:n]


def _pack2(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """Two u32 keys -> one int64 key with the same lexicographic order."""
    return ((hi - (1 << 31)) << 32) | lo


def lexsort(*keys: torch.Tensor) -> torch.Tensor:
    """Stable permutation that sorts rows by keys[0], then keys[1], ...
    (every key a 1-D int64 tensor of u32 values).  Pairs of keys pack
    into one int64, so k keys cost ceil(k/2) stable sorts."""
    packed = []
    ks = list(keys)
    while ks:
        if len(ks) >= 2:
            lo, hi = ks.pop(), ks.pop()
            packed.append(_pack2(hi, lo))
        else:
            packed.append(ks.pop())
    perm = None
    for p in packed:           # least significant first
        v = p if perm is None else p[perm]
        o = torch.argsort(v, stable=True)
        perm = o if perm is None else perm[o]
    return perm


def seg_ids(new_seg: torch.Tensor) -> torch.Tensor:
    """bool [N] first-of-segment flags -> int64 segment ids."""
    return torch.cumsum(new_seg.to(torch.int64), 0) - 1


def segment_sum(vals: torch.Tensor, ids: torch.Tensor, n: int) -> torch.Tensor:
    out = torch.zeros(n, dtype=vals.dtype, device=vals.device)
    return out.index_add_(0, ids, vals)


def segment_max(vals: torch.Tensor, ids: torch.Tensor, n: int) -> torch.Tensor:
    """Per-segment max; segments with no rows hold the dtype's minimum."""
    lo = torch.iinfo(vals.dtype).min if not vals.dtype.is_floating_point \
        else float("-inf")
    out = torch.full((n,), lo, dtype=vals.dtype, device=vals.device)
    return out.scatter_reduce(0, ids, vals, "amax", include_self=True)


def first_of_run(*cols: torch.Tensor) -> torch.Tensor:
    """bool [N]: row differs from the previous row in any column (row 0
    always starts a run)."""
    n = cols[0].shape[0]
    new = torch.zeros(n, dtype=torch.bool, device=cols[0].device)
    if n:
        new[0] = True
        for c in cols:
            new[1:] |= c[1:] != c[:-1]
    return new
