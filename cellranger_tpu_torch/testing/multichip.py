"""Dry run of the mesh path over n devices (the JAX package's
`__graft_entry__.dryrun_multichip`).

    python -m cellranger_tpu_torch.testing.multichip --devices cpu --n 8

Part 1 drives the production run_count on a mesh, and again with the
kmer table sharded over it, and holds both to the one-device run: equal
summaries (wall excluded), MEX bytes and molecule_info.  Part 2 runs the sharded step on a synthetic batch against
the one-device step (every plane, the metrics), the sharded pass-1
histogram, and the all-to-all barcode shuffle dedup on the step's rows.
"""

from __future__ import annotations

import argparse
import dataclasses
import gzip
import json
import os
import tempfile

import numpy as np
import torch

MEX = [os.path.join(sub, f) for sub in ("raw_feature_bc_matrix",
                                        "filtered_feature_bc_matrix")
       for f in ("matrix.mtx.gz", "barcodes.tsv.gz", "features.tsv.gz")]


def _same_outputs(a: str, b: str, what: str) -> None:
    from ..io.molecule_info import load_molecule_info
    for f in MEX:
        with gzip.open(os.path.join(a, f)) as fa, \
                gzip.open(os.path.join(b, f)) as fb:
            assert fa.read() == fb.read(), f"{what}: {f} diverged"
    ma = load_molecule_info(os.path.join(a, "molecule_info.h5"))
    mb = load_molecule_info(os.path.join(b, "molecule_info.h5"))
    for k in ("barcode_idx", "feature_idx", "umi", "count"):
        assert np.array_equal(ma[k], mb[k]), \
            f"{what}: molecule_info[{k}] diverged"


def dryrun_multichip(n: int, devices) -> dict:
    """Mesh of the first n of `devices` (repeats allowed); raises on any
    divergence from the one-device run.  Returns what it checked."""
    from ..ops import barcode as bcops
    from ..ops.bucket_table import BucketTable
    from ..parallel.mesh import (make_mesh, make_sharded_bc_histogram,
                                 make_sharded_step, shard_batch_arrays)
    from ..parallel.shuffle import make_sharded_dedup
    from ..pipeline.count import (CountConfig, fetch_step_out, run_count,
                                  unpack_step_out)
    from .fixtures import (build_tiny_mesh_run, synthetic_batch,
                           synthetic_step_setup)

    mesh = make_mesh(n, devices=devices)
    home = mesh.devices[0]

    # ---- part 1: the production pipeline on the mesh ----
    tmp = tempfile.mkdtemp(prefix="crt_dryrun_")
    fx = build_tiny_mesh_run(os.path.join(tmp, "fx"))
    cfg = CountConfig(fastq_pairs=[(fx["fq1"], fx["fq2"])],
                      reference_path=fx["ref"], whitelist_path=fx["wl"],
                      chemistry="SC3Pv3", read_len=91, batch_size=n * 16,
                      secondary_analysis=False, checkpoint=False)
    outs = {v: os.path.join(tmp, v) for v in ("single", "mesh", "shard")}
    sums = dict(
        single=run_count(cfg, outs["single"], device=home),
        mesh=run_count(cfg, outs["mesh"], device=home, mesh=mesh),
        shard=run_count(dataclasses.replace(cfg, shard_index=True),
                        outs["shard"], device=home, mesh=mesh))
    s0 = sums["single"]
    assert s0["total_reads"] == fx["n_reads"], s0["total_reads"]
    assert s0["mapped_frac"] > 0.9, s0["mapped_frac"]
    assert s0["total_molecules"] > 0
    for v in ("mesh", "shard"):
        off = [k for k in s0 if k != "wall_time_s"
               and json.dumps(s0[k]) != json.dumps(sums[v].get(k))]
        assert not off, f"{v} summary diverged: {off}"
        _same_outputs(outs["single"], outs[v], v)

    # ---- part 2: synthetic sharded step, histogram, shuffle dedup ----
    make_step, wl, genome, rng = synthetic_step_setup()
    B = 64 * n
    plane, host = synthetic_batch(wl, genome, rng, B)
    ho0, m0 = unpack_step_out(fetch_step_out(make_step(home)(
        torch.from_numpy(plane.view(np.int32)).to(home))))
    sharded = make_sharded_step(lambda d: make_step(d).planes, mesh)
    out = {k: v.cpu() for k, v in sharded(shard_batch_arrays(
        mesh, {"plane": plane})["plane"]).items()}
    ho, m = unpack_step_out(out)
    assert m["n_mapped"] >= int(0.95 * B), f"mapped {m['n_mapped']}/{B}"
    assert m == m0, f"sharded metrics diverged: {m} != {m0}"
    for k in sorted(ho0):
        assert np.array_equal(ho0[k], ho[k]), f"sharded plane {k} diverged"

    wl_table = BucketTable.build_exact(
        wl.sorted_seqs, np.arange(wl.size, dtype=np.uint32), home,
        entries=8, fields=3).with_counts(np.ones(wl.size, np.int64))
    _hit, idx = bcops.whitelist_lookup(
        torch.from_numpy(host["bc_packed"].astype(np.int64)).to(home),
        wl_table)
    sb = shard_batch_arrays(mesh, {"idx": idx.cpu().numpy(),
                                   "valid": np.ones(B, bool)})
    hist = make_sharded_bc_histogram(mesh, wl.size)(sb["idx"], sb["valid"])
    assert int(hist.sum()) == B, "histogram sum diverged"

    rows = shard_batch_arrays(mesh, dict(
        bc=host["bc_idx"].astype(np.uint32).astype(np.int64),
        gene=ho["gene"].astype(np.int64),
        umi=host["umi"].astype(np.int64), valid=ho["conf_ok"]))
    dd = make_sharded_dedup(mesh, B // n, 12, slack=8.0)(
        rows["bc"], rows["gene"], rows["umi"], rows["valid"])
    n_mol = int(dd["n_molecules"].sum())
    assert int(dd["overflow"].sum()) == 0 and n_mol > 0
    return dict(devices=[str(d) for d in mesh.devices],
                molecules=s0["total_molecules"],
                conf_mapped_frac=s0["conf_mapped_frac"], step_metrics=m,
                shuffle_molecules=n_mol)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--devices", default="cuda",
                   help="device of every mesh entry (cpu, cuda, cuda:1)")
    p.add_argument("--n", type=int, default=8, help="mesh size")
    a = p.parse_args(argv)
    print(json.dumps(dryrun_multichip(a.n, [a.devices] * a.n)))


if __name__ == "__main__":
    main()
