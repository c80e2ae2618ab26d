"""Multi-host scale-out plumbing over torch.distributed (gloo).

Port of cellranger_tpu/parallel/distributed.py, with the same CRTPU_*
environment contract, so one launcher drives either package.  One
process per host joins a process group; each streams only its share of
the FASTQ pairs, the pass-1 whitelist histogram and the resume vote are
summed across hosts, and molecule spill partitions written under the
shared output directory are read back by host 0 for dedup and outputs.

Only host arrays cross hosts, so the group uses the gloo backend over
TCP: it needs no GPU collective, and several processes may share one
card.  Single-host runs never touch this module's state: `init_from_env`
is a no-op unless the coordinator variable is set, and `process_index`
and `process_count` fall back to (0, 1).
"""

from __future__ import annotations

import datetime
import os

import numpy as np
import torch
import torch.distributed as tdist

# Environment contract (set by the launcher on every host):
#   CRTPU_COORDINATOR    host:port of process 0
#   CRTPU_NUM_PROCESSES  total process count
#   CRTPU_PROCESS_ID     this process's id (0-based)
ENV_COORD = "CRTPU_COORDINATOR"
ENV_NPROC = "CRTPU_NUM_PROCESSES"
ENV_PID = "CRTPU_PROCESS_ID"

# how long a collective waits for the other hosts before it fails
TIMEOUT = datetime.timedelta(minutes=30)


def _up() -> bool:
    return tdist.is_available() and tdist.is_initialized()


def init_from_env() -> bool:
    """Join the process group named by the CRTPU_* variables; returns True
    when a multi-host group is up (idempotent, no-op without them)."""
    if _up():
        return True
    coord = os.environ.get(ENV_COORD)
    if not coord:
        return False
    tdist.init_process_group(
        "gloo", init_method=f"tcp://{coord}",
        world_size=int(os.environ[ENV_NPROC]),
        rank=int(os.environ[ENV_PID]), timeout=TIMEOUT)
    return True


def process_index() -> int:
    return tdist.get_rank() if _up() else 0


def process_count() -> int:
    return tdist.get_world_size() if _up() else 1


def host_shard(items: list, pid: int | None = None,
               nproc: int | None = None) -> list:
    """Deterministic round-robin assignment of work items (FASTQ pairs) to
    hosts: host k takes items k, k+n, k+2n, ...  Round-robin (not block)
    keeps read mass balanced when pair sizes vary monotonically."""
    pid = process_index() if pid is None else pid
    nproc = process_count() if nproc is None else nproc
    return items[pid::nproc]


def allsum_array(x) -> np.ndarray:
    """Element-wise sum of a host-local integer array across all hosts,
    exact (int64 all_reduce), in the array's own dtype."""
    x = np.asarray(x)
    if process_count() == 1:
        return x
    t = torch.from_numpy(x.astype(np.int64))
    tdist.all_reduce(t, op=tdist.ReduceOp.SUM)
    return t.numpy().astype(x.dtype)


def barrier(name: str = "sync") -> None:
    """Block until every host reaches this point (spill handoff fence);
    `name` labels the fence for a reader of the code."""
    if process_count() > 1:
        tdist.barrier()
