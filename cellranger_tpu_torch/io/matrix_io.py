"""Feature x barcode count matrix, 10x-compatible on-disk formats.

Produces/reads the reference's matrix HDF5 v2 layout
(lib/python/cellranger/matrix.py:70-79,492-530; h5_constants.py:25-45):

    /  attrs: filetype="matrix", version=2 [, software_version, library_ids,
              original_gem_groups, chemistry_description]
    /matrix/{data int32, indices int64, indptr int64, shape int32[2]}  (CSC,
        rows=features, cols=barcodes)
    /matrix/barcodes  (bytes, "ACGT...-<gem_group>")
    /matrix/features/{id, name, feature_type, genome, _all_tag_keys}

and the MEX triple (matrix.mtx.gz, features.tsv.gz, barcodes.tsv.gz).

Verbatim copy of cellranger_tpu/io/matrix_io.py: the port keeps its own copy of
every jax-free module it needs and imports nothing of that package.
"""

from __future__ import annotations

import gzip
import os
from dataclasses import dataclass, field

import numpy as np
import scipy.sparse as sp

GENE_EXPRESSION = "Gene Expression"
ANTIBODY_CAPTURE = "Antibody Capture"
CRISPR_GUIDE = "CRISPR Guide Capture"
MULTIPLEXING = "Multiplexing Capture"


@dataclass
class FeatureDef:
    id: str
    name: str
    feature_type: str = GENE_EXPRESSION
    genome: str = ""
    tags: dict = field(default_factory=dict)


@dataclass
class FeatureReference:
    """Ordered feature definitions (genes first, then feature-barcode
    features), mirroring cr_types feature_reference.rs:451 semantics."""

    feature_defs: list[FeatureDef]

    @property
    def n_features(self) -> int:
        return len(self.feature_defs)

    @property
    def ids(self) -> list[str]:
        return [f.id for f in self.feature_defs]

    def genomes(self) -> list[str]:
        return sorted({f.genome for f in self.feature_defs if f.genome})

    @staticmethod
    def from_transcriptome(gene_ids, gene_names, genome: str = "") -> "FeatureReference":
        return FeatureReference(
            [FeatureDef(i, n, GENE_EXPRESSION, genome)
             for i, n in zip(gene_ids, gene_names)])


@dataclass
class CountMatrix:
    """CSC matrix: rows = features, cols = barcodes (matrix.py:287)."""

    m: sp.csc_matrix
    barcodes: list[bytes]     # b"ACGT...-1"
    features: FeatureReference

    @property
    def shape(self):
        return self.m.shape

    def counts_per_bc(self) -> np.ndarray:
        return np.asarray(self.m.sum(axis=0)).ravel()

    def counts_per_feature(self) -> np.ndarray:
        return np.asarray(self.m.sum(axis=1)).ravel()

    def select_barcodes(self, idx) -> "CountMatrix":
        return CountMatrix(self.m[:, idx].tocsc(),
                           [self.barcodes[i] for i in np.atleast_1d(idx)],
                           self.features)

    @staticmethod
    def from_molecules(bc_idx: np.ndarray, gene: np.ndarray,
                       barcodes: list[bytes], features: FeatureReference
                       ) -> "CountMatrix":
        """Build from per-molecule (barcode index, feature index) pairs."""
        n_f, n_b = features.n_features, len(barcodes)
        data = np.ones(len(bc_idx), dtype=np.int32)
        m = sp.coo_matrix((data, (gene, bc_idx)), shape=(n_f, n_b),
                          dtype=np.int32).tocsc()
        m.sum_duplicates()
        return CountMatrix(m, barcodes, features)

    # ---------- HDF5 ----------
    def save_h5(self, path: str, chemistry_description: str = "custom",
                library_ids=("count",), sw_version: str = "cellranger-tpu-0.1.0",
                extra_attrs: dict | None = None):
        from . import hdf5 as h5py

        def strs(xs):
            return np.asarray([x if isinstance(x, bytes) else str(x).encode()
                               for x in xs], dtype="S")

        with h5py.File(path, "w") as f:
            f.attrs["filetype"] = "matrix"
            f.attrs["version"] = 2
            f.attrs["software_version"] = sw_version
            f.attrs["chemistry_description"] = chemistry_description
            f.attrs["library_ids"] = strs(library_ids)
            f.attrs["original_gem_groups"] = np.asarray([1], dtype=np.int64)
            for k, v in (extra_attrs or {}).items():
                f.attrs[k] = v
            g = f.create_group("matrix")
            csc = self.m.tocsc()
            csc.sort_indices()
            # gzip level 1: ~5x faster writes than the default level 4 for
            # ~5% size — matrix writes showed up in run profiles
            opts = dict(compression="gzip", compression_opts=1, shuffle=True)
            g.create_dataset("data", data=csc.data.astype(np.int32), **opts)
            g.create_dataset("indices", data=csc.indices.astype(np.int64), **opts)
            g.create_dataset("indptr", data=csc.indptr.astype(np.int64), **opts)
            g.create_dataset("shape", data=np.asarray(csc.shape, np.int32))
            g.create_dataset("barcodes", data=strs(self.barcodes), **opts)
            fg = g.create_group("features")
            fds = self.features.feature_defs
            fg.create_dataset("id", data=strs([d.id for d in fds]), **opts)
            fg.create_dataset("name", data=strs([d.name for d in fds]), **opts)
            fg.create_dataset("feature_type",
                              data=strs([d.feature_type for d in fds]), **opts)
            fg.create_dataset("genome", data=strs([d.genome for d in fds]), **opts)
            fg.create_dataset("_all_tag_keys", data=strs(["genome"]))

    @staticmethod
    def load_h5(path: str) -> "CountMatrix":
        from . import hdf5 as h5py

        with h5py.File(path, "r") as f:
            g = f["matrix"]
            shape = tuple(g["shape"][:])
            m = sp.csc_matrix(
                (g["data"][:], g["indices"][:], g["indptr"][:]), shape=shape)
            barcodes = [bytes(b) for b in g["barcodes"][:]]
            fg = g["features"]
            defs = [FeatureDef(i.decode(), n.decode(), t.decode(), ge.decode())
                    for i, n, t, ge in zip(fg["id"][:], fg["name"][:],
                                           fg["feature_type"][:], fg["genome"][:])]
        return CountMatrix(m, barcodes, FeatureReference(defs))

    # ---------- MEX ----------
    @staticmethod
    def _gz_det(path: str, compresslevel: int = 9):
        """Deterministic gzip writer: mtime pinned to 0 so identical
        content yields identical bytes across runs (golden stability)."""
        import io as _io
        raw = open(path, "wb")
        gz = gzip.GzipFile(filename="", mode="wb", fileobj=raw,
                           compresslevel=compresslevel, mtime=0)
        return _io.TextIOWrapper(_WrapClose(gz, raw))

    def save_mex(self, directory: str):
        os.makedirs(directory, exist_ok=True)
        coo = self.m.tocoo()
        with self._gz_det(os.path.join(directory, "matrix.mtx.gz"),
                          compresslevel=1) as f:
            f.write("%%MatrixMarket matrix coordinate integer general\n")
            f.write('%metadata_json: {"software_version": "cellranger-tpu-0.1.0", '
                    '"format_version": 2}\n')
            f.write(f"{self.m.shape[0]} {self.m.shape[1]} {coo.nnz}\n")
            # one vectorized format pass (a python loop here was minutes at
            # 100M-nnz scale)
            rows = np.char.add(np.char.add(
                (coo.row + 1).astype(np.int64).astype("U"), " "), np.char.add(
                np.char.add((coo.col + 1).astype(np.int64).astype("U"), " "),
                coo.data.astype(np.int64).astype("U")))
            f.write("\n".join(rows.tolist()))
            if len(rows):
                f.write("\n")
        with self._gz_det(os.path.join(directory, "features.tsv.gz")) as f:
            for d in self.features.feature_defs:
                f.write(f"{d.id}\t{d.name}\t{d.feature_type}\n")
        with self._gz_det(os.path.join(directory, "barcodes.tsv.gz")) as f:
            for b in self.barcodes:
                f.write(b.decode() + "\n")


class _WrapClose:
    """File-object proxy that closes BOTH the gzip member and the
    underlying raw file (GzipFile(fileobj=...) leaves the raw open)."""

    def __init__(self, gz, raw):
        self._gz = gz
        self._raw = raw

    def write(self, b):
        return self._gz.write(b)

    def writable(self):
        return True

    def readable(self):
        return False

    def seekable(self):
        return False

    def flush(self):
        self._gz.flush()

    def close(self):
        self._gz.close()
        self._raw.close()

    @property
    def closed(self):
        return self._raw.closed
