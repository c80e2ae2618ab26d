"""Device mesh and sharded execution of the counting step.

Port of cellranger_tpu/parallel/mesh.py.  The JAX package runs its step
under `shard_map` over a `jax.sharding.Mesh`; the port's mesh is single-
controller in the same way: one process drives an ordered list of
`torch.device`s, and the list may repeat a device (a mesh of
`["cuda:0"] * 4` runs every line of the sharded code on one card, as the
JAX tests' 8 virtual CPU devices do).

  * reads are data-parallel over the mesh: batch slice i runs on
    devices[i] against a replica of the index on that device (one replica
    per distinct device);
  * per-read outputs are concatenated in slice order and the integer
    metric vectors are summed: the `psum` of the JAX package, exact;
  * the partition dedup runs partition d on devices[d].
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from ..ops.barcode import count_valid_barcodes
from ..ops.dedup import dedup_molecules


@dataclass(frozen=True)
class Mesh:
    """An ordered list of devices along one data axis."""

    devices: tuple[torch.device, ...]
    axis: str = "data"

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def distinct(self) -> tuple[torch.device, ...]:
        """The devices of the mesh, each once, in mesh order."""
        return tuple(dict.fromkeys(self.devices))


def _device(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def make_mesh(n_devices: int | None = None, axis: str = "data", *,
              devices=None) -> Mesh:
    """The first n_devices of `devices` (default: every visible CUDA
    device).  `devices` may repeat an entry: ["cpu"] * 8 is the mesh the
    CPU tests use, ["cuda:0"] * 4 runs the sharded path on one card."""
    if devices is None:
        n_cuda = torch.cuda.device_count()
        if n_cuda == 0:
            raise RuntimeError("make_mesh: no CUDA device is visible; pass "
                               "devices= (e.g. ['cpu'] * 8)")
        devices = [f"cuda:{i}" for i in range(n_cuda)]
    devs = [_device(d) for d in devices]
    n = n_devices or len(devs)
    if n > len(devs):
        raise ValueError(f"make_mesh: {n} devices asked, {len(devs)} given")
    return Mesh(tuple(devs[:n]), axis)


def to_device(obj, device):
    """A copy of a dataclass of tensors (nested dataclasses included) with
    every tensor on `device`; tensors already there are shared."""
    changes = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, torch.Tensor):
            changes[f.name] = v.to(device)
        elif dataclasses.is_dataclass(v):
            changes[f.name] = to_device(v, device)
    return dataclasses.replace(obj, **changes)


def split(mesh: Mesh, a) -> list[torch.Tensor]:
    """A host array or tensor -> its N equal dim-0 slices, slice i on
    devices[i].  uint32 arrays travel as their int32 bits."""
    if isinstance(a, np.ndarray):
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        a = torch.from_numpy(np.ascontiguousarray(a))
    n = mesh.size
    if a.shape[0] % n:
        raise ValueError(f"dim 0 of {tuple(a.shape)} does not split over "
                         f"{n} devices")
    return [s.to(d) for s, d in zip(torch.chunk(a, n), mesh.devices)]


def shard_batch_arrays(mesh: Mesh, arrays: dict) -> dict:
    """Place batch arrays sharded on dim 0 across the mesh: name -> list
    of per-device slices."""
    return {k: split(mesh, v) for k, v in arrays.items()}


def gather(parts: list[torch.Tensor]) -> torch.Tensor:
    """Per-device slices -> one tensor on the first slice's device, in
    slice order."""
    home = parts[0].device
    return torch.cat([p.to(home) for p in parts], 0)


def psum(parts: list[torch.Tensor]) -> torch.Tensor:
    """Element-wise sum of per-device tensors, on the first one's device."""
    home = parts[0].device
    out = parts[0].clone()
    for p in parts[1:]:
        out += p.to(home)
    return out


def make_sharded_step(step_for_device, mesh: Mesh):
    """Data-parallel step over the mesh.

    step_for_device(device) builds the step against a replica of the index
    on that device; it is called once per distinct device.  The returned
    function takes the per-device slices of the batch (`split`), runs
    slice i on devices[i], and returns the step's output dict with every
    per-read tensor concatenated in slice order and the metrics ("mvec"
    vector or "metrics" dict of scalars) summed."""
    steps = {d: step_for_device(d) for d in mesh.distinct}

    def wrapped(slices):
        outs = [steps[s.device](s) for s in slices]
        merged = {}
        for k, v in outs[0].items():
            if k == "mvec":
                merged[k] = psum([o[k] for o in outs])
            elif k == "metrics":
                merged[k] = {m: psum([o[k][m] for o in outs]) for m in v}
            else:
                merged[k] = gather([o[k] for o in outs])
        return merged

    return wrapped


def make_sharded_part_dedup(mesh: Mesh, umi_len: int):
    """Dedup over pre-partitioned molecule rows: slice d of (bc, gene,
    umi, valid) holds barcode-hash partition d and is deduplicated on
    devices[d].  No exchange is needed because the host spill already
    routed every read of a barcode to one partition.  Returns the [n*N,
    12] int32 plane of DD_FIELDS columns, partition-major (the JAX
    package's sharded output)."""
    from .executor import DD_FIELDS, _pack_dd

    def f(bc, gene, umi, valid):
        planes = []
        for b, g, u, v in zip(bc, gene, umi, valid):
            dd = dedup_molecules(b, g, u, v, umi_len)
            planes.append(_pack_dd(dd, DD_FIELDS))
        return gather(planes)

    return f


def make_sharded_bc_histogram(mesh: Mesh, wl_size: int):
    """Pass-1 whitelist counting: each device histograms its slice, and
    the histograms are summed (int32 [W])."""

    def f(idx, valid):
        return psum([count_valid_barcodes(i, v, wl_size)
                     for i, v in zip(idx, valid)])

    return f
