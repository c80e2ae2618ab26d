"""Port parity for the stream-mode step of cellranger_tpu_torch (BAM runs):
`make_stream_step(..., emit_secondary=True)` + `unpack_step_out` against
the JAX package's `_make_step(..., accumulate=False,
emit_secondary=True)` + `unpack_step_out` on Gene Expression batches of
the rich fixture (multimappers with secondary loci, a novel junction,
TSO/polyA reads).  Every named host array, with its dtype, and every
metric are equal.
"""

import numpy as np
import pytest
import jax.numpy as jnp

from cellranger_tpu.align.aligner import DeviceIndex as JaxDeviceIndex
from cellranger_tpu.align.annotate import AnnotationIndex as JaxAnnIndex
from cellranger_tpu.io.chemistry import get_chemistry as jax_get_chemistry
from cellranger_tpu.io.reference import ReferencePackage as JaxRefPackage
from cellranger_tpu.pipeline import count as jax_count
from cellranger_tpu_torch.align.aligner import DeviceIndex
from cellranger_tpu_torch.align.annotate import AnnotationIndex
from cellranger_tpu_torch.io.chemistry import get_chemistry
from cellranger_tpu_torch.io.fastq import batches_from_fastqs
from cellranger_tpu_torch.io.whitelist import Whitelist
from cellranger_tpu_torch.ops.barcode import host_resolve_barcodes
from cellranger_tpu_torch.pipeline import count as tcount
from cellranger_tpu_torch.testing.fixtures import build_rich_run

B = 1024


@pytest.fixture(scope="module")
def rich(tmp_path_factory):
    fx = build_rich_run(str(tmp_path_factory.mktemp("rich")), n_cells=40)
    ref = JaxRefPackage.load(fx["ref"])
    gi = ref.genome_index
    jdidx = JaxDeviceIndex.from_host(gi)
    jann = JaxAnnIndex.build(ref.transcriptome, gi)
    return fx, jdidx, jann


def test_stream_step_matches_jax(rich):
    fx, jdidx, jann = rich
    chem, jchem = get_chemistry("SC3Pv3"), jax_get_chemistry("SC3Pv3")
    jstep = jax_count._make_step(jdidx, jann, jchem, 91, accumulate=False,
                                 emit_secondary=True)
    tstep = tcount.make_stream_step(DeviceIndex.from_jax(jdidx, "cpu"),
                                    AnnotationIndex.from_jax(jann, "cpu"),
                                    chem, 91, emit_secondary=True)
    wl = Whitelist.load(fx["wl"])
    counts = np.ones(wl.size, np.int64)
    seen = dict(sec=0, nsj=0, mm=0, conf=0)
    batches = batches_from_fastqs(chem, fx["fq1"], fx["fq2"], B, 91)
    for _, batch in zip(range(2), batches):
        bc_idx = host_resolve_barcodes(
            batch.bc_packed, batch.bc_qual, batch.slot_valid,
            wl.sorted_seqs, counts, chem.barcode_length)[0]
        plane = tcount.pack_step_input(chem, 91, batch, bc_idx)
        np.testing.assert_array_equal(
            plane, jax_count.pack_step_input(jchem, 91, batch, bc_idx))
        want_ho, want_m = jax_count.unpack_step_out(
            jstep(jnp.asarray(plane)))
        got_ho, got_m = tcount.unpack_step_out(tcount.fetch_step_out(
            tstep(tcount.upload_plane(plane, "cpu"))))
        assert got_m == want_m
        assert set(got_ho) == set(want_ho)
        for k, w in want_ho.items():
            w = np.asarray(w)
            assert got_ho[k].dtype == w.dtype, k
            np.testing.assert_array_equal(got_ho[k], w, err_msg=k)
        seen["sec"] += int(got_ho["sec_ok"].sum())
        seen["nsj"] += int(got_ho["novel_sj"].sum())
        seen["mm"] += int(got_ho["mm"].sum())
        seen["conf"] += int(got_ho["conf_ok"].sum())
    # the batches exercise every BAM-only column
    assert all(v > 0 for v in seen.values()), seen


def test_stream_step_without_secondaries(rich):
    """Count-width planes (no sec_* block) unpack to the JAX layout."""
    fx, jdidx, jann = rich
    chem, jchem = get_chemistry("SC3Pv3"), jax_get_chemistry("SC3Pv3")
    tstep = tcount.make_stream_step(DeviceIndex.from_jax(jdidx, "cpu"),
                                    AnnotationIndex.from_jax(jann, "cpu"),
                                    chem, 91)
    jstep = jax_count._make_step(jdidx, jann, jchem, 91, accumulate=False)
    batch = next(iter(batches_from_fastqs(chem, fx["fq1"], fx["fq2"], 256,
                                          91)))
    bc_idx = np.full(256, -1, np.int32)
    plane = tcount.pack_step_input(chem, 91, batch, bc_idx)
    got = tcount.fetch_step_out(tstep(tcount.upload_plane(plane, "cpu")))
    want = jstep(jnp.asarray(plane))
    for k in ("i32", "flags", "mvec"):
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
    ho, _ = tcount.unpack_step_out(got)
    assert "sec_pos" not in ho and not ho["conf_ok"].any()
