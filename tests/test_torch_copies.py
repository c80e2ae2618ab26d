"""The port's copies of the JAX package's jax-free modules are copies.

cellranger_tpu_torch imports nothing of cellranger_tpu; what it needs of
that package's jax-free modules it holds as verbatim copies at the same
relative path.  Each case compares a copy with its original after dropping
import lines and the module docstring (the only places a copy may differ),
so a later reader learns when the reference and a copy have drifted.  The
reference is frozen, so they should not.

`pipeline/demux.py`, `pipeline/multi_gem.py`, `pipeline/aggr.py` and
`io/multi_config.py` call `run_count`, `run_vdj` and
`run_secondary_analysis`, which need a device in the port: they are
copies but for that keyword threaded down (THREADED_MODULES).  Their
syntax trees are compared after the port's changes are undone one by one
(`_Unthread`: the keyword-only `device` parameter and each
`device=device` argument dropped); what is left must be equal, statement
for statement.

`vdj/assembly.py` is the original but for its device half: every other
top-level function, class and assignment must have the original's syntax
tree.

`native/__init__.py` is the other copy with a deliberate change (it builds
the FASTQ reader's library under build/native/, not into a package
directory): its `NativeFastqReader` class and the C++ source are compared
instead, and the build directory is checked.
"""

import ast
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ORIGINAL = os.path.join(REPO, "cellranger_tpu")
COPY = os.path.join(REPO, "cellranger_tpu_torch")

COPIED_MODULES = [
    "constants.py", "params.py", "perf.py", "metrics.py",
    "io/chemistry.py", "io/gtf.py", "io/matrix_io.py", "io/molecule_info.py",
    "io/bam.py", "io/bam_index.py", "io/bam_read.py",
    "pipeline/spill.py", "pipeline/checkpoint.py", "pipeline/runtime.py",
    "pipeline/websummary.py",
    "analysis/sgt.py", "analysis/cell_calling.py", "analysis/subsample.py",
    "analysis/multigenome.py", "analysis/aggregates.py",
    "analysis/feature_assigner.py",
    "analysis/preprocess.py", "analysis/hclust.py",
    "testing/correctness.py",
    "io/probe_set.py", "io/probe_bc.py", "io/bam_filter.py",
    "analysis/jibes.py",
    "pipeline/detect_chemistry.py", "pipeline/preflight.py",
    "stats.py", "vdj/reference.py", "vdj/annotate.py", "io/bcl.py",
    "pipeline/mkfastq.py",
]

# copies that differ from their original only where the port needs it: a
# keyword `device` threaded down to run_count / run_vdj /
# run_secondary_analysis
THREADED_MODULES = ["pipeline/demux.py", "pipeline/multi_gem.py",
                    "pipeline/aggr.py", "io/multi_config.py"]


def _read(root, rel):
    with open(os.path.join(root, rel)) as f:
        return f.read()


def _body_lines(text):
    """Source lines without the module docstring and without any import
    statement (at any depth), blank lines dropped."""
    tree = ast.parse(text)
    drop = set()
    first = tree.body[0]
    if isinstance(first, ast.Expr) and isinstance(first.value, ast.Constant) \
            and isinstance(first.value.value, str):
        drop.update(range(first.lineno, first.end_lineno + 1))
    for node in ast.walk(tree):
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            drop.update(range(node.lineno, node.end_lineno + 1))
    return [ln.rstrip() for i, ln in enumerate(text.split("\n"), 1)
            if i not in drop and ln.strip()]


@pytest.mark.parametrize("rel", COPIED_MODULES)
def test_copy_equals_original(rel):
    want = _body_lines(_read(ORIGINAL, rel))
    got = _body_lines(_read(COPY, rel))
    assert len(want) > 10, rel
    assert got == want, f"{rel} has drifted from cellranger_tpu/{rel}"


def _is_docstring(stmt):
    return isinstance(stmt, ast.Expr) \
        and isinstance(stmt.value, ast.Constant) \
        and isinstance(stmt.value.value, str)


class _Unthread(ast.NodeTransformer):
    """Undo, on a syntax tree, the changes a threaded copy may carry (and
    nothing else); imports and docstrings go from both trees."""

    def _block(self, stmts):
        out = []
        for st in stmts:
            if isinstance(st, (ast.Import, ast.ImportFrom)) \
                    or _is_docstring(st):
                continue
            st = self.visit(st)
            out.extend(st if isinstance(st, list) else [st])
        return out or [ast.Pass()]

    def generic_visit(self, node):
        for field in ("body", "orelse", "finalbody"):
            block = getattr(node, field, None)
            if isinstance(block, list) and block \
                    and isinstance(block[0], ast.stmt):
                setattr(node, field, self._block(block))
        for field, value in ast.iter_fields(node):
            if field in ("body", "orelse", "finalbody"):
                continue
            if isinstance(value, list):
                setattr(node, field, [self.visit(v) if isinstance(v, ast.AST)
                                      else v for v in value])
            elif isinstance(value, ast.AST):
                setattr(node, field, self.visit(value))
        return node

    def visit_FunctionDef(self, node):
        keep = [i for i, a in enumerate(node.args.kwonlyargs)
                if a.arg != "device"]
        node.args.kwonlyargs = [node.args.kwonlyargs[i] for i in keep]
        node.args.kw_defaults = [node.args.kw_defaults[i] for i in keep]
        return self.generic_visit(node)

    def visit_Call(self, node):
        self.generic_visit(node)
        node.keywords = [
            k for k in node.keywords
            if not (k.arg == "device" and isinstance(k.value, ast.Name)
                    and k.value.id == "device")]
        return node


def _normalised(root, rel):
    tree = ast.parse(_read(root, rel))
    tree.body = _Unthread()._block(tree.body)
    return ast.unparse(ast.fix_missing_locations(tree)).split("\n")


@pytest.mark.parametrize("rel", THREADED_MODULES)
def test_threaded_copy_differs_only_by_device(rel):
    import difflib

    assert _body_lines(_read(ORIGINAL, rel)) \
        != _body_lines(_read(COPY, rel)), \
        f"{rel} is a verbatim copy: list it in COPIED_MODULES"
    want, got = _normalised(ORIGINAL, rel), _normalised(COPY, rel)
    assert len(want) > 50, rel
    diff = list(difflib.unified_diff(want, got, "original", "copy",
                                     lineterm="", n=1))
    assert not diff, f"{rel} differs beyond device threading:\n" \
        + "\n".join(diff)


# the device half of vdj/assembly.py (the original's `_join64` joined the
# kmer words its device sorts returned; the port's sort key holds the
# joined kmer), and the port's helpers of it and the graph workers' task
VDJ_DEVICE = {"_rolling_kmers_2w", "_join64", "count_bc_kmers",
              "count_bc_umi_kmers"}
VDJ_PORT_HELPERS = {"_sort_count", "_kmer_spectrum", "KMER_BITS",
                    "KMER_MASK", "RANKS_PER_KEY", "DEFAULT_CHUNK",
                    "_assemble_spectra"}


def _top_level(text):
    """{name: ast dump} of the module's top-level functions, classes and
    single-name assignments."""
    out = {}
    for node in ast.parse(text).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            out[node.name] = ast.dump(node)
        elif isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            out[node.targets[0].id] = ast.dump(node)
    return out


def test_vdj_assembly_differs_only_in_its_device_half():
    rel = "vdj/assembly.py"
    want, got = _top_level(_read(ORIGINAL, rel)), _top_level(_read(COPY, rel))
    host = set(want) - VDJ_DEVICE
    assert len(host) >= 20 and {"BarcodeGraph", "contig_base_quals",
                                "umi_support", "assemble_barcode"} <= host
    differ = sorted(n for n in host if got.get(n) != want[n])
    assert not differ, f"{rel}: {differ} differ from the original"
    assert set(got) - set(want) == VDJ_PORT_HELPERS
    assert set(want) - set(got) == {"_join64"}


def _class_source(text, name):
    for node in ast.parse(text).body:
        if isinstance(node, ast.ClassDef) and node.name == name:
            return ast.get_source_segment(text, node)
    raise AssertionError(f"no class {name}")


def test_native_reader_copy():
    rel = "native/fastq_reader.cpp"
    assert _read(COPY, rel) == _read(ORIGINAL, rel)
    rel = "native/__init__.py"
    assert _class_source(_read(COPY, rel), "NativeFastqReader") \
        == _class_source(_read(ORIGINAL, rel), "NativeFastqReader")


def test_native_reader_builds_under_the_build_root():
    from cellranger_tpu_torch import kernels, native

    build_root = os.path.join(REPO, "build")
    assert os.path.dirname(native.BUILD_DIR) == build_root
    assert os.path.dirname(kernels.BUILD_DIR) == build_root
    lib = native.get_lib()
    if lib is not None:                 # a toolchain is present
        assert os.path.exists(os.path.join(native.BUILD_DIR,
                                           "libfastq_reader.so"))
    so = [f for d, _, fs in os.walk(COPY) for f in fs if f.endswith(".so")]
    assert not so, so
