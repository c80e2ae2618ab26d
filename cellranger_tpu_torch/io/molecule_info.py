"""molecule_info.h5 writer/reader, reference v6 format.

Layout per lib/python/cellranger/molecule_counter.py:60-140 and the Rust
writer cr_h5/src/molecule_info.rs:668:

  / attrs: file_version=6
  /gem_group uint16, /barcode_idx uint64, /feature_idx uint32,
  /library_idx uint16, /umi uint32 (2-bit packed), /count uint32,
  /umi_type uint32 (1 = transcriptomic)
  /barcodes: whitelist barcode strings (the barcode_idx target space)
  /features/...: feature reference (id/name/feature_type/genome)
  /library_info: JSON string list of {library_type, library_id, gem_group}
  /barcode_info/{pass_filter [N,3] (bc_idx, library_idx, genome_idx),
                 genomes}
  /metrics_json: JSON dataset of run metrics

Verbatim copy of cellranger_tpu/io/molecule_info.py: the port keeps its own copy of
every jax-free module it needs and imports nothing of that package.
"""

from __future__ import annotations

import json

import numpy as np

from .matrix_io import FeatureReference

FILE_VERSION = 6
UMI_TYPE_TXOMIC = np.uint32(1)


def save_molecule_info(
    path: str,
    barcode_idx: np.ndarray,   # per molecule, index into `barcodes`
    feature_idx: np.ndarray,
    umi: np.ndarray,           # uint32 2-bit packed
    count: np.ndarray,         # reads per molecule
    barcodes: list[bytes],
    features: FeatureReference,
    gem_group: int = 1,
    library_idx: np.ndarray | None = None,
    library_info: list[dict] | None = None,
    pass_filter_bc_idx: np.ndarray | None = None,
    metrics: dict | None = None,
    umi_type: np.ndarray | None = None,
    gem_group_per_mol: np.ndarray | None = None,
):
    from . import hdf5 as h5py

    n = len(barcode_idx)
    # reference sorts molecules by (gem_group, barcode_idx) for chunking
    order = np.argsort(barcode_idx, kind="stable")

    def strs(xs):
        return np.asarray([x if isinstance(x, bytes) else str(x).encode()
                           for x in xs], dtype="S")

    with h5py.File(path, "w") as f:
        f.attrs["file_version"] = FILE_VERSION
        opts = dict(compression="gzip")
        gg = (np.asarray(gem_group_per_mol, np.uint16)
              if gem_group_per_mol is not None
              else np.full(n, gem_group, np.uint16))
        f.create_dataset("gem_group", data=gg[order], **opts)
        f.create_dataset("barcode_idx",
                         data=barcode_idx[order].astype(np.uint64), **opts)
        f.create_dataset("feature_idx",
                         data=feature_idx[order].astype(np.uint32), **opts)
        f.create_dataset(
            "library_idx",
            data=(library_idx[order] if library_idx is not None
                  else np.zeros(n)).astype(np.uint16), **opts)
        f.create_dataset("umi", data=umi[order].astype(np.uint32), **opts)
        f.create_dataset("count", data=count[order].astype(np.uint32), **opts)
        f.create_dataset(
            "umi_type",
            data=(umi_type[order] if umi_type is not None
                  else np.full(n, UMI_TYPE_TXOMIC)).astype(np.uint32), **opts)
        # the reference stores RAW barcode sequences (no gem-group suffix;
        # molecule_counter.py:483 — format_barcode_seq appends "-<gg>" at
        # use time).  Normalize so reference readers (run_subsampling,
        # aggr) resolve cell membership correctly.
        def unsuffix(b):
            b = b if isinstance(b, bytes) else str(b).encode()
            head, sep, tail = b.rpartition(b"-")
            return head if sep and tail.isdigit() else b

        f.create_dataset("barcodes", data=strs([unsuffix(b)
                                                for b in barcodes]), **opts)

        fg = f.create_group("features")
        fds = features.feature_defs
        fg.create_dataset("id", data=strs([d.id for d in fds]), **opts)
        fg.create_dataset("name", data=strs([d.name for d in fds]), **opts)
        fg.create_dataset("feature_type",
                          data=strs([d.feature_type for d in fds]), **opts)
        fg.create_dataset("genome", data=strs([d.genome for d in fds]), **opts)
        fg.create_dataset("_all_tag_keys", data=strs(["genome"]))

        li = library_info or [
            {"library_type": "Gene Expression", "library_id": "0",
             "gem_group": gem_group}]
        # 1-element string ARRAY (not a scalar): the reference reader
        # slices it (molecule_counter.py:720 read_hdf5_string_dataset[0])
        f.create_dataset("library_info", data=strs([json.dumps(li)]))

        big = f.create_group("barcode_info")
        genomes = features.genomes() or [""]
        if pass_filter_bc_idx is None:
            pf = np.zeros((0, 3), np.uint64)
        else:
            pf = np.stack([
                pass_filter_bc_idx.astype(np.uint64),
                np.zeros(len(pass_filter_bc_idx), np.uint64),
                np.zeros(len(pass_filter_bc_idx), np.uint64)], axis=1)
        big.create_dataset("pass_filter", data=pf)
        big.create_dataset("genomes", data=strs(genomes))

        f.create_dataset("metrics_json", data=json.dumps(metrics or {}))


def load_molecule_info(path: str) -> dict:
    from . import hdf5 as h5py

    with h5py.File(path, "r") as f:
        out = {k: f[k][:] for k in ["gem_group", "barcode_idx", "feature_idx",
                                    "library_idx", "umi", "count", "umi_type",
                                    "barcodes"]}
        li = f["library_info"][()]
        if isinstance(li, np.ndarray):   # 1-element string array form
            li = li[0]
        out["library_info"] = json.loads(li)
        out["metrics"] = json.loads(f["metrics_json"][()])
        out["pass_filter"] = f["barcode_info/pass_filter"][:]
        out["features_id"] = f["features/id"][:]
        out["file_version"] = int(f.attrs["file_version"])
    return out


def subset_molecule_info(src: str, dst: str, keep_barcodes) -> int:
    """Per-sample molecule_info (MULTI_WRITE_PER_SAMPLE_MOLECULE_INFO,
    mro/rna/_basic_sc_rna_counter.mro:277-294): copy `src` keeping only
    molecules whose barcode is in `keep_barcodes` (bytes, without the
    gem-group suffix or with — both accepted); pass_filter keeps only the
    sample's rows.  Returns the molecule count written."""
    from . import hdf5 as h5py

    keep = set()
    for b in keep_barcodes:
        b = b if isinstance(b, bytes) else b.encode()
        keep.add(b)
        keep.add(b.rsplit(b"-", 1)[0])
    with h5py.File(src, "r") as f, h5py.File(dst, "w") as g:
        barcodes = f["barcodes"][:]
        bc_keep = np.asarray([b in keep or b.rsplit(b"-", 1)[0] in keep
                              for b in barcodes])
        bidx = f["barcode_idx"][:]
        row_keep = bc_keep[bidx.astype(np.int64)]
        g.attrs["file_version"] = f.attrs["file_version"]
        opts = dict(compression="gzip")
        for k in ("gem_group", "barcode_idx", "feature_idx", "library_idx",
                  "umi", "count", "umi_type"):
            g.create_dataset(k, data=f[k][:][row_keep], **opts)
        g.create_dataset("barcodes", data=barcodes, **opts)
        f.copy("features", g)
        g.create_dataset("library_info", data=f["library_info"][()])
        bi = g.create_group("barcode_info")
        pf = f["barcode_info/pass_filter"][:]
        if len(pf):
            pf = pf[bc_keep[pf[:, 0].astype(np.int64)]]
        bi.create_dataset("pass_filter", data=pf)
        bi.create_dataset("genomes", data=f["barcode_info/genomes"][:])
        g.create_dataset("metrics_json", data=f["metrics_json"][()])
        return int(row_keep.sum())
