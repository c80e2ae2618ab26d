"""Seconds and peak RSS of the port's per-sample molecule_info subsets
(`io/molecule_info.subset_molecule_info`, as the demux of a multiplexed
run calls it) under three ways of passing a dataset's gzip chunks through
`io/hdf5.py`:

  serial    one chunk at a time on the calling thread
  unbounded every chunk on threads, all of a dataset's results held
            before they are used
  window    on threads, at most two results a thread held at once (the
            port's `_ordered_map`)

A synthetic molecule_info.h5 of a multiplexed Flex well's size is written
once (default: the 40M-read-pair well's 25,765,983 molecules over its
737,280 x 16 = 11,796,480 product barcodes, 4,000 cells in 16 samples,
400,000 ambient barcodes, 18,000 genes); then each way runs in a child
process of its own, in the order serial, unbounded, window, window,
unbounded, serial, each child subsetting the same samples.  A child
reports its seconds a call, its RSS before the first call and its peak
RSS (`ru_maxrss`).  Host only: no device is used.

    python3 tools/molinfo_subset_bench.py [--molecules N] [--barcodes N]
        [--cells N] [--ambient N] [--calls N] [--out FILE]

prints one JSON object and writes it to --out.
"""

from __future__ import annotations

import argparse
import json
import os
import resource
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

SAMPLES = 16
GENES = 18_000
WAYS = ("serial", "unbounded", "window", "window", "unbounded", "serial")


def _rss_bytes() -> int:
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) * 1024
    return 0


def _set_way(way: str) -> None:
    from concurrent.futures import ThreadPoolExecutor

    from cellranger_tpu_torch.io import hdf5

    if way == "serial":
        hdf5._ordered_map = lambda fn, items: map(fn, items)
    elif way == "unbounded":
        def unbounded(fn, items):
            if len(items) < 2:
                return map(fn, items)
            with ThreadPoolExecutor(min(len(items),
                                        os.cpu_count() or 1)) as ex:
                return list(ex.map(fn, items))
        hdf5._ordered_map = unbounded
    elif way != "window":
        raise ValueError(way)


def child(way: str, work: str, calls: int) -> dict:
    _set_way(way)
    from cellranger_tpu_torch.io.molecule_info import subset_molecule_info

    with open(os.path.join(work, "samples.json")) as f:
        samples = json.load(f)
    rss0 = _rss_bytes()
    secs, kept = [], []
    for s in range(calls):
        dst = os.path.join(work, f"sample_{way}_{s}.h5")
        t = time.perf_counter()
        kept.append(subset_molecule_info(
            os.path.join(work, "molecule_info.h5"), dst,
            [b.encode() for b in samples[s]]))
        secs.append(time.perf_counter() - t)
        os.remove(dst)
    peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    return dict(way=way, seconds_a_call=secs, molecules_kept=kept,
                rss_before_bytes=rss0, peak_rss_bytes=peak,
                peak_over_before_bytes=peak - rss0)


def build(work: str, n_mol: int, n_bc: int, n_cells: int,
          n_amb: int, seed: int = 0) -> dict:
    from cellranger_tpu_torch.io.matrix_io import FeatureDef, FeatureReference
    from cellranger_tpu_torch.io.molecule_info import save_molecule_info

    rng = np.random.default_rng(seed)
    names = np.frombuffer(b"ACGT", np.uint8)[
        rng.integers(0, 4, (n_bc, 24), np.uint8)]
    names = np.ascontiguousarray(names).view("S24").ravel()
    used = rng.choice(n_bc, n_cells + n_amb, replace=False)
    cells, amb = used[:n_cells], used[n_cells:]
    in_cells = int(n_mol * 0.95) if n_amb else n_mol
    bidx = np.concatenate([cells[rng.integers(0, n_cells, in_cells)],
                           amb[rng.integers(0, max(n_amb, 1),
                                            n_mol - in_cells)]])
    feats = FeatureReference([FeatureDef(f"G{g:05d}", f"gene{g}")
                              for g in range(GENES)])
    t = time.perf_counter()
    save_molecule_info(
        os.path.join(work, "molecule_info.h5"), bidx.astype(np.uint64),
        rng.integers(0, GENES, n_mol).astype(np.uint32),
        rng.integers(0, 1 << 24, n_mol).astype(np.uint32),
        rng.integers(1, 6, n_mol).astype(np.uint32),
        names.tolist(), feats, pass_filter_bc_idx=np.sort(cells))
    write_s = time.perf_counter() - t
    per = np.array_split(np.sort(cells), SAMPLES)
    with open(os.path.join(work, "samples.json"), "w") as f:
        json.dump([[names[c].decode() + "-1" for c in p] for p in per], f)
    return dict(molecules=n_mol, barcodes=n_bc, cells=n_cells,
                ambient=n_amb, write_s=write_s,
                file_bytes=os.path.getsize(
                    os.path.join(work, "molecule_info.h5")))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--molecules", type=int, default=25_765_983)
    ap.add_argument("--barcodes", type=int, default=737_280 * SAMPLES)
    ap.add_argument("--cells", type=int, default=4_000)
    ap.add_argument("--ambient", type=int, default=400_000)
    ap.add_argument("--calls", type=int, default=2)
    ap.add_argument("--out", default="")
    ap.add_argument("--child", default="")
    ap.add_argument("--work", default="")
    a = ap.parse_args()
    if a.child:
        print(json.dumps(child(a.child, a.work, a.calls)))
        return
    work = tempfile.mkdtemp(prefix="molinfo_bench_")
    try:
        rep = build(work, a.molecules, a.barcodes, a.cells, a.ambient)
        rep["cpu_count"] = os.cpu_count()
        rep["runs"] = []
        for way in WAYS:
            p = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--child", way,
                 "--work", work, "--calls", str(a.calls)],
                capture_output=True, text=True, check=True)
            rep["runs"].append(json.loads(p.stdout.strip().splitlines()[-1]))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    line = json.dumps(rep)
    if a.out:
        os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
        with open(a.out, "w") as f:
            f.write(line + "\n")
    print(line)


if __name__ == "__main__":
    main()
