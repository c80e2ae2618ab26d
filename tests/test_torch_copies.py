"""The port's copies of the JAX package's jax-free modules are copies.

cellranger_tpu_torch imports nothing of cellranger_tpu; what it needs of
that package's jax-free modules it holds as verbatim copies at the same
relative path.  Each case compares a copy with its original after dropping
import lines and the module docstring (the only places a copy may differ),
so a later reader learns when the reference and a copy have drifted.  The
reference is frozen, so they should not.

`native/__init__.py` is the one copy with a deliberate change (it builds
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
    "analysis/preprocess.py", "analysis/hclust.py", "analysis/diffexp.py",
    "testing/correctness.py",
]


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
