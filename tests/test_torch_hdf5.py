"""The port's HDF5 library (cellranger_tpu_torch/io/hdf5.py) against h5py.

  * the port writes, real h5py reads: every dataset and attribute that
    `save_h5`, `save_molecule_info` and `subset_molecule_info` write, from
    the same arrays as the JAX package's copies writing through h5py, at a
    tiny size, past 64 chunks a dataset (a chunk B-tree of two levels or
    more), with an empty matrix, a zero-size `pass_filter`, non-ASCII text
    in a variable-length attribute and `extra_attrs`: the same tree,
    dtypes, shapes, values, attributes, chunk shapes, compression, level
    and shuffle as h5py reports them for the JAX package's file;
  * h5py writes, the port reads: the golden snapshots
    `tests/golden/e2e*/*.h5`, and the JAX package's writers' files past 64
    chunks and with their attributes moved to continuation blocks;
  * hypothesis round trips over dtypes, shapes (0 included) and strings in
    both directions, and h5py's own chunk rule against the port's.
"""

import glob
import os
import struct

import h5py
import numpy as np
import pytest
import scipy.sparse as sp
from hypothesis import given, settings
from hypothesis import strategies as st

from cellranger_tpu.io import matrix_io as jmio
from cellranger_tpu.io import molecule_info as jmi
from cellranger_tpu.testing import correctness as jax_cc
from cellranger_tpu_torch.io import hdf5
from cellranger_tpu_torch.io import matrix_io as tmio
from cellranger_tpu_torch.io import molecule_info as tmi

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = sorted(glob.glob(os.path.join(REPO, "tests", "golden", "e2e*",
                                       "*.h5")))


# ------------------------------------------------------------ helpers
def _same_value(a, b) -> bool:
    if type(a) is not type(b):
        return False
    if isinstance(a, np.ndarray):
        return a.dtype == b.dtype and a.shape == b.shape \
            and np.array_equal(a, b)
    return a == b


def _h5_diffs(a: str, b: str) -> list[str]:
    """Differences between two files as h5py reads them: tree, dtypes,
    shapes, values, attributes (value and type), chunks, compression,
    level, shuffle."""
    diffs = []

    def attrs(x, y, p):
        if sorted(x.attrs) != sorted(y.attrs):
            diffs.append(f"{p}: attrs {sorted(x.attrs)} != {sorted(y.attrs)}")
            return
        for k in x.attrs:
            if not _same_value(x.attrs[k], y.attrs[k]):
                diffs.append(f"{p}@{k}: {x.attrs[k]!r} != {y.attrs[k]!r}")

    def walk(x, y, p):
        attrs(x, y, p)
        if isinstance(x, h5py.Dataset) != isinstance(y, h5py.Dataset):
            diffs.append(f"{p}: group vs dataset")
            return
        if isinstance(x, h5py.Dataset):
            for prop in ("shape", "dtype", "chunks", "compression",
                         "compression_opts", "shuffle"):
                if getattr(x, prop) != getattr(y, prop):
                    diffs.append(f"{p}.{prop}: {getattr(x, prop)!r} != "
                                 f"{getattr(y, prop)!r}")
            if h5py.check_string_dtype(x.dtype) \
                    != h5py.check_string_dtype(y.dtype):
                diffs.append(f"{p}: string dtypes differ")
            if not _same_value(x[()], y[()]):
                diffs.append(f"{p}: values differ")
            return
        if sorted(x) != sorted(y):
            diffs.append(f"{p}: keys {sorted(x)} != {sorted(y)}")
            return
        for k in x:
            walk(x[k], y[k], f"{p}/{k}")

    with h5py.File(a, "r") as fa, h5py.File(b, "r") as fb:
        walk(fa, fb, "")
    return diffs


def h5_layout_diffs(a: str, b: str) -> list[str]:
    """Differences in tree and storage between two files as h5py reads
    them: keys, shapes, dtypes, chunks, compression, level, shuffle. Values
    and attributes are the JAX package's comparators' part."""
    diffs = []

    def walk(x, y, p):
        if isinstance(x, h5py.Dataset) != isinstance(y, h5py.Dataset):
            diffs.append(f"{p}: group vs dataset")
        elif isinstance(x, h5py.Dataset):
            for prop in ("shape", "dtype", "chunks", "compression",
                         "compression_opts", "shuffle"):
                if getattr(x, prop) != getattr(y, prop):
                    diffs.append(f"{p}.{prop}: {getattr(x, prop)!r} != "
                                 f"{getattr(y, prop)!r}")
        elif sorted(x) != sorted(y):
            diffs.append(f"{p}: keys {sorted(x)} != {sorted(y)}")
        else:
            for k in x:
                walk(x[k], y[k], f"{p}/{k}")

    with h5py.File(a, "r") as fa, h5py.File(b, "r") as fb:
        walk(fa, fb, "")
    return diffs


def h5_parity_diffs(actual: str, expected: str,
                    molecule_info: bool = False) -> list[str]:
    """What real h5py finds between a file the port wrote and the JAX
    package's: that package's comparator (check_molecule_info for a
    molecule_info file, else check_h5) plus h5_layout_diffs. The parity
    tests of the pipelines use it, never the port's own reader."""
    check = jax_cc.check_molecule_info if molecule_info else jax_cc.check_h5
    return check(actual, expected) + h5_layout_diffs(actual, expected)


def _port_read_diffs(path: str) -> list[str]:
    """Differences between what the port's reader and h5py read from one
    file: tree, shapes, dtypes, values, attributes, chunks, filters."""
    diffs = []

    def walk(x, y, p):
        if sorted(x.attrs) != sorted(y.attrs):
            diffs.append(f"{p}: attrs")
        for k in y.attrs:
            if not _same_value(x.attrs[k], y.attrs[k]):
                diffs.append(f"{p}@{k}: {x.attrs[k]!r} != {y.attrs[k]!r}")
        if isinstance(y, h5py.Dataset):
            if not isinstance(x, hdf5.Dataset):
                diffs.append(f"{p}: not a dataset")
                return
            for prop in ("shape", "dtype", "chunks", "compression",
                         "compression_opts", "shuffle"):
                if getattr(x, prop) != getattr(y, prop):
                    diffs.append(f"{p}.{prop}: {getattr(x, prop)!r} != "
                                 f"{getattr(y, prop)!r}")
            if not _same_value(x[()], y[()]):
                diffs.append(f"{p}: values differ")
            return
        if not isinstance(x, hdf5.Group) or list(x.keys()) != list(y.keys()):
            diffs.append(f"{p}: keys {list(x.keys())} != {list(y.keys())}")
            return
        for k in y:
            walk(x[k], y[k], f"{p}/{k}")

    with hdf5.File(path, "r") as fx, h5py.File(path, "r") as fy:
        walk(fx, fy, "")
    return diffs


def _btree_levels(path: str, dataset: str) -> int:
    """Levels of the chunk B-tree of `dataset` (1 + the root's level)."""
    with h5py.File(path, "r") as f:
        off = f[dataset].id.get_offset()       # None for chunked storage
        assert off is None and f[dataset].chunks
    with hdf5.File(path, "r") as f:
        btree = f[dataset]._layout[1]
    with open(path, "rb") as fh:
        fh.seek(btree)
        head = fh.read(6)
    assert head[:4] == b"TREE" and head[4] == 1
    return head[5] + 1


def _root_header_continues(path: str) -> bool:
    """Whether the root group's object header (superblock 0) holds a
    continuation message in its first block."""
    with open(path, "rb") as fh:
        b = fh.read()
    root, = struct.unpack_from("<Q", b, 64)
    size, = struct.unpack_from("<I", b, root + 8)
    p, end = root + 16, root + 16 + size
    while p < end:
        mtype, msize = struct.unpack_from("<HH", b, p)
        if mtype == hdf5.MSG_CONTINUATION:
            return True
        p += 8 + msize
    return False


def _features(pkg, n: int, genomes=("GRCh38", "mm10")):
    return pkg.FeatureReference([
        pkg.FeatureDef(f"G{i:05d}", f"gene{i}",
                       "Gene Expression" if i % 7 else "Antibody Capture",
                       genomes[i % len(genomes)]) for i in range(n)])


def _matrix(pkg, n_feat: int, n_bc: int, nnz: int, seed: int):
    rng = np.random.default_rng(seed)
    m = sp.csc_matrix((rng.integers(1, 50, nnz).astype(np.int32),
                       (rng.integers(0, n_feat, nnz),
                        rng.integers(0, n_bc, nnz))),
                      shape=(n_feat, n_bc)) if n_bc else \
        sp.csc_matrix((n_feat, 0), dtype=np.int32)
    m.sum_duplicates()
    barcodes = [b"ACGT%012d-1" % i for i in range(n_bc)]
    return pkg.CountMatrix(m, barcodes, _features(pkg, n_feat))


MATRIX_CASES = {
    "tiny": dict(n_feat=5, n_bc=7, nnz=12, kw={}),
    "empty": dict(n_feat=4, n_bc=0, nnz=0, kw={}),
    # 1M non-zeros: 128 chunks of data, 256 of indices (>= 2 levels)
    "multi_chunk": dict(n_feat=3000, n_bc=40_000, nnz=1_000_000, kw={}),
    "attrs": dict(n_feat=6, n_bc=5, nnz=9, kw=dict(
        chemistry_description="Single Cell 3′ v3 ü中",
        library_ids=("libé", b"two"),
        extra_attrs={"count": 3, "ratio": 0.25, "note": "déjà",
                     "raw": b"bytes", "ids": np.arange(4, dtype=np.uint16),
                     "names": np.asarray([b"a", b"bc"])})),
}


# ------------------------------------------------ port writes, h5py reads
@pytest.mark.parametrize("case", sorted(MATRIX_CASES))
def test_save_h5_equals_h5py_file(case, tmp_path):
    c = MATRIX_CASES[case]
    shape = (c["n_feat"], c["n_bc"], c["nnz"])
    t, j = str(tmp_path / "t.h5"), str(tmp_path / "j.h5")
    _matrix(tmio, *shape, seed=1).save_h5(t, **c["kw"])
    _matrix(jmio, *shape, seed=1).save_h5(j, **c["kw"])
    assert not _h5_diffs(t, j)
    if case == "multi_chunk":
        with h5py.File(t, "r") as f:
            ind = f["matrix/indices"]
            assert -(-len(ind) // ind.chunks[0]) > 64
        assert _btree_levels(t, "matrix/indices") >= 2
    # and it reads back through the port's own loader
    back = tmio.CountMatrix.load_h5(t)
    want = jmio.CountMatrix.load_h5(j)
    assert back.barcodes == want.barcodes and (back.m != want.m).nnz == 0
    assert [vars(d) for d in back.features.feature_defs] \
        == [vars(d) for d in want.features.feature_defs]


def _molecules(n: int, n_bc: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return dict(
        barcode_idx=rng.integers(0, max(n_bc, 1), n).astype(np.int64),
        feature_idx=rng.integers(0, 9, n).astype(np.int64),
        umi=rng.integers(0, 1 << 20, n).astype(np.uint32),
        count=rng.integers(1, 30, n).astype(np.int64),
        barcodes=[b"AC%014d-1" % i for i in range(n_bc)])


MOLECULE_CASES = {
    "tiny": dict(n=40, n_bc=12, cells=[1, 3, 5], kw={}),
    "no_cells": dict(n=40, n_bc=12, cells=None, kw={}),
    "empty": dict(n=0, n_bc=3, cells=[], kw={}),
    # 600,000 molecules: 192 chunks of uint64 (>= 2 levels)
    "multi_chunk": dict(n=600_000, n_bc=5000, cells=list(range(0, 5000, 3)),
                        kw={}),
    "gem_groups": dict(n=50, n_bc=10, cells=[2], kw=dict(
        library_info=[{"library_type": "Gene Expression", "library_id": "0",
                       "gem_group": 1},
                      {"library_type": "Antibody Capture",
                       "library_id": "1", "gem_group": 2}],
        metrics={"total_reads": 1234, "chemistry": "SC3Pv3",
                 "sample_id": "sü"})),
}


def _save_molecules(pkg_mi, pkg_mio, path, case):
    c = MOLECULE_CASES[case]
    mol = _molecules(c["n"], c["n_bc"], seed=2)
    kw = dict(c["kw"])
    if case == "gem_groups":
        rng = np.random.default_rng(3)
        kw.update(library_idx=rng.integers(0, 2, c["n"]),
                  gem_group_per_mol=rng.integers(1, 3, c["n"]),
                  umi_type=rng.integers(0, 2, c["n"]))
    pkg_mi.save_molecule_info(
        path, mol["barcode_idx"], mol["feature_idx"], mol["umi"],
        mol["count"], mol["barcodes"], _features(pkg_mio, 9),
        pass_filter_bc_idx=(None if c["cells"] is None
                            else np.asarray(c["cells"], np.int64)), **kw)


@pytest.mark.parametrize("case", sorted(MOLECULE_CASES))
def test_save_molecule_info_equals_h5py_file(case, tmp_path):
    t, j = str(tmp_path / "t.h5"), str(tmp_path / "j.h5")
    _save_molecules(tmi, tmio, t, case)
    _save_molecules(jmi, jmio, j, case)
    assert not _h5_diffs(t, j)
    if case == "multi_chunk":
        assert _btree_levels(t, "barcode_idx") >= 2
    if case == "no_cells":
        with h5py.File(t, "r") as f:
            assert f["barcode_info/pass_filter"].shape == (0, 3)
    got, want = tmi.load_molecule_info(t), jmi.load_molecule_info(j)
    assert sorted(got) == sorted(want)
    for k in want:
        assert _same_value(got[k], want[k]) or got[k] == want[k], k


@pytest.mark.parametrize("case", ["tiny", "no_cells", "multi_chunk"])
def test_subset_molecule_info_equals_h5py_file(case, tmp_path):
    """The port's subset of the port's file against the JAX package's
    subset of its own (h5py) file; Group.copy carries `features` over."""
    t, j = str(tmp_path / "t.h5"), str(tmp_path / "j.h5")
    _save_molecules(tmi, tmio, t, case)
    _save_molecules(jmi, jmio, j, case)
    n_bc = MOLECULE_CASES[case]["n_bc"]
    keep = [b"AC%014d-1" % i for i in range(0, n_bc, 2)]
    ts, js = str(tmp_path / "ts.h5"), str(tmp_path / "js.h5")
    n_t = tmi.subset_molecule_info(t, ts, keep)
    n_j = jmi.subset_molecule_info(j, js, keep)
    assert n_t == n_j > 0
    assert not _h5_diffs(ts, js)


# ------------------------------------------------ h5py writes, port reads
@pytest.mark.parametrize("path", GOLDEN,
                         ids=[os.path.relpath(p, REPO) for p in GOLDEN])
def test_port_reads_golden(path):
    assert not _port_read_diffs(path)


def test_port_reads_h5py_multi_level_and_continuation(tmp_path):
    """JAX-written files with chunk B-trees of two levels and more, and a
    root group whose attributes h5py moved out to continuation blocks."""
    m, mol = str(tmp_path / "m.h5"), str(tmp_path / "mol.h5")
    _matrix(jmio, 3000, 40_000, 1_000_000, seed=4).save_h5(
        m, extra_attrs={f"attr{i:02d}": "v" * 40 for i in range(30)})
    _save_molecules(jmi, jmio, mol, "multi_chunk")
    assert _root_header_continues(m)
    assert _btree_levels(m, "matrix/indices") >= 2
    assert _btree_levels(mol, "barcode_idx") >= 2
    assert not _port_read_diffs(m)
    assert not _port_read_diffs(mol)
    got = tmio.CountMatrix.load_h5(m)
    want = jmio.CountMatrix.load_h5(m)
    assert got.barcodes == want.barcodes and (got.m != want.m).nnz == 0


def test_port_reads_h5py_compact_layout(tmp_path):
    """A dataset h5py stores in its object header (compact layout)."""
    p = str(tmp_path / "c.h5")
    dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
    dcpl.set_layout(h5py.h5d.COMPACT)
    with h5py.File(p, "w") as f:
        f.create_dataset("c", data=np.arange(6, dtype=np.int32).reshape(2, 3),
                         dcpl=dcpl)
        assert f["c"].id.get_create_plist().get_layout() == h5py.h5d.COMPACT
    assert not _port_read_diffs(p)


def test_api_subset(tmp_path):
    """Paths, membership, copy, attributes, read-only and refused types."""
    p = str(tmp_path / "a.h5")
    with hdf5.File(p, "w") as f:
        g = f.create_group("a/b")
        g.create_dataset("x", data=np.arange(5, dtype=np.int16),
                         compression="gzip", compression_opts=9, shuffle=True)
        f["a"].attrs["n"] = 7
        f.create_dataset("s", data="text")
        with pytest.raises(TypeError):
            f.create_dataset("u", data=np.asarray(["a"]))    # numpy unicode
        with pytest.raises(TypeError):
            f.create_dataset("z", data=np.int32(3), compression="gzip")
        with pytest.raises(ValueError):
            f.create_dataset("s", data=b"again")
    with hdf5.File(p, "r") as f:
        assert "a/b/x" in f and "a/c" not in f and f.keys() == ["a", "s"]
        assert isinstance(f["a"], hdf5.Group) and isinstance(f["/a/b/x"],
                                                             hdf5.Dataset)
        x = f["a/b/x"]
        assert x[:].tolist() == x[...].tolist() == [0, 1, 2, 3, 4]
        for key in (slice(1, 3), 2, (slice(None),), np.arange(2)):
            with pytest.raises(TypeError):      # only whole reads
                x[key]
        assert (x.chunks, x.compression, x.compression_opts, x.shuffle) \
            == ((5,), "gzip", 9, True)
        assert f["a"].attrs["n"] == 7 and type(f["a"].attrs["n"]) is np.int64
        assert f["s"][()] == b"text"
        with pytest.raises(OSError):
            f.create_group("new")
        with pytest.raises(OSError):
            f.attrs["k"] = 1
        q = str(tmp_path / "b.h5")
        with hdf5.File(q, "w") as g:
            f.copy("a", g)
    with h5py.File(q, "r") as g, h5py.File(p, "r") as f:
        assert list(g) == ["a"] and g["a"].attrs["n"] == 7
        assert g["a/b/x"].chunks == (5,) and g["a/b/x"].shuffle
        assert g["a/b/x"].compression_opts == 9
        assert np.array_equal(g["a/b/x"][()], f["a/b/x"][()])
    with pytest.raises(ValueError):
        x[()]                                   # the file is closed
    bad = tmp_path / "bad.h5"
    bad.write_bytes(b"not an hdf5 file at all")
    with pytest.raises(OSError):
        hdf5.File(str(bad), "r")


# ------------------------------------------------------ hypothesis
_NUMERIC = ["u1", "u2", "u4", "u8", "i1", "i2", "i4", "i8", "f4", "f8"]
_TEXT = st.text(st.characters(blacklist_categories=("Cs",),
                              blacklist_characters="\x00"), max_size=12)
_ASCII = st.binary(max_size=9).map(lambda b: b.replace(b"\x00", b"."))


@st.composite
def _dataset(draw):
    kind = draw(st.sampled_from(_NUMERIC + ["S", "vlen"]))
    shape = tuple(draw(st.lists(st.integers(0, 40), max_size=2)))
    n = int(np.prod(shape))
    if kind == "vlen":
        data = np.empty(shape, dtype=h5py.string_dtype())
        data.reshape(-1)[:] = draw(st.lists(_TEXT, min_size=n, max_size=n))
    elif kind == "S":
        data = np.asarray(draw(st.lists(_ASCII, min_size=n, max_size=n)) or
                          [b""], dtype="S")[:n].reshape(shape)
    else:
        rng = np.random.default_rng(draw(st.integers(0, 2 ** 32 - 1)))
        dt = np.dtype(kind)
        if dt.kind == "f":
            data = rng.standard_normal(n).astype(dt).reshape(shape)
        else:
            info = np.iinfo(dt)
            data = rng.integers(info.min, info.max, n, dtype=dt,
                                endpoint=True).reshape(shape)
    opts = {}
    if shape and draw(st.booleans()):
        opts = dict(compression="gzip",
                    compression_opts=draw(st.integers(0, 9)),
                    shuffle=draw(st.booleans()))
    attrs = draw(st.dictionaries(
        st.text("abcdefgh", min_size=1, max_size=6),
        st.one_of(st.integers(-2 ** 63, 2 ** 63 - 1), _TEXT,
                  st.floats(allow_nan=False),
                  st.lists(st.integers(0, 255), max_size=5).map(
                      lambda v: np.asarray(v, np.uint8))),
        max_size=4))
    return data, opts, attrs


def _write(module, path, items):
    with module.File(path, "w") as f:
        for i, (data, opts, attrs) in enumerate(items):
            ds = f.create_dataset(f"g{i % 2}/d{i}", data=data,
                                  dtype=data.dtype, **opts)
            for k, v in attrs.items():
                ds.attrs[k] = v


@settings(max_examples=40, deadline=None)
@given(st.lists(_dataset(), min_size=1, max_size=5))
def test_round_trip_both_directions(tmp_path_factory, items):
    d = tmp_path_factory.mktemp("rt")
    t, j = str(d / "t.h5"), str(d / "j.h5")
    _write(hdf5, t, items)
    _write(h5py, j, items)
    assert not _h5_diffs(t, j)              # the port wrote, h5py reads
    assert not _port_read_diffs(j)          # h5py wrote, the port reads
    assert not _port_read_diffs(t)


@settings(max_examples=200, deadline=None)
@given(st.lists(st.integers(0, 5_000_000), min_size=1, max_size=3),
       st.sampled_from([1, 2, 4, 8, 16, 18, 72]))
def test_guess_chunk_is_h5pys(shape, typesize):
    from h5py._hl.filters import guess_chunk
    assert hdf5.guess_chunk(tuple(shape), typesize) \
        == guess_chunk(tuple(shape), None, typesize)


# ------------------------------------------------------------ timing
def time_writers(n_mol: int = 499_995, n_bc: int = 20_000,
                 n_feat: int = 800, nnz: int = 400_000, repeat: int = 3,
                 tmp: str | None = None) -> dict:
    """Host seconds (best of `repeat`) of the port's `save_h5`,
    `save_molecule_info` and their readers against the JAX package's
    copies through h5py, on the same arrays, at the 1M-read e2e run's
    sizes by default: 499,995 molecules over a 20,000-barcode whitelist
    and 800 genes."""
    import tempfile
    import time

    tmp = tmp or tempfile.mkdtemp(prefix="h5_timing_")
    out = {}
    for name, mio, mi in (("port", tmio, tmi), ("h5py", jmio, jmi)):
        mat = _matrix(mio, n_feat, n_bc, nnz, seed=1)
        mol = _molecules(n_mol, n_bc, seed=2)
        cells = np.arange(0, n_bc, 10, dtype=np.int64)
        feats = _features(mio, n_feat)
        path = os.path.join(tmp, f"{name}_mat.h5")
        mpath = os.path.join(tmp, f"{name}_mol.h5")
        best = dict(matrix_write_s=[], matrix_read_s=[],
                    molecule_info_write_s=[], molecule_info_read_s=[])
        for _ in range(repeat):
            t = time.perf_counter()
            mat.save_h5(path)
            best["matrix_write_s"].append(time.perf_counter() - t)
            t = time.perf_counter()
            mio.CountMatrix.load_h5(path)
            best["matrix_read_s"].append(time.perf_counter() - t)
            t = time.perf_counter()
            mi.save_molecule_info(mpath, mol["barcode_idx"],
                                  mol["feature_idx"], mol["umi"],
                                  mol["count"], mol["barcodes"], feats,
                                  pass_filter_bc_idx=cells)
            best["molecule_info_write_s"].append(time.perf_counter() - t)
            t = time.perf_counter()
            mi.load_molecule_info(mpath)
            best["molecule_info_read_s"].append(time.perf_counter() - t)
        out[name] = {k: min(v) for k, v in best.items()}
        out[name].update(matrix_bytes=os.path.getsize(path),
                         molecule_info_bytes=os.path.getsize(mpath))
    return out


if __name__ == "__main__":
    # python tests/test_torch_hdf5.py: the timing above, as one JSON line
    import json
    import platform

    print(json.dumps(dict(host=platform.processor() or platform.machine(),
                          cpus=os.cpu_count(), **time_writers())))
