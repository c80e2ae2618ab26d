"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one line; any failure raises and exits non-zero:

  device       require CUDA; print the card, its capability and power limit
  build        compile the hand-written kernels (csrc/*.cu) from the checkout
  sw_kernel    the banded Smith-Waterman kernel against its plain torch
               version at the main path's shapes (B = 8192, 8191, 1;
               L = 91): all outputs equal; CUDA-event times of both
  tiny_parity  the synthetic run through run_count on cuda and on cpu:
               identical metrics (except wall_time_s) and MEX matrices
  e2e          the 1M-read fixture through run_count on cuda at batch
               32768: read and molecule counts against the JAX package's
               values for this fixture, wall time, phase split, memory

The line before the last is the kernel report (JSON); the last line is
{"ok": true, "device": {...}}.  Imports nothing of JAX.
"""

from __future__ import annotations

import gzip
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

E2E_READS = 1_000_000
E2E_BATCH = 32768
# the JAX package's outputs for this fixture (BENCH_r05.json, e2e)
E2E_TOTAL_MOLECULES = 499_995
E2E_CONF_MAPPED_FRAC = 1.0
SW_SHAPES = (8192, 8191, 1)      # 8192 = batch 32768 // RESCUE_CAP_FRAC
SW_READ_LEN = 91


def phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


def nvidia_smi_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median of `reps` CUDA-event timings of fn() after warm-up."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def check_sw_kernel() -> dict:
    """Kernel vs plain version on the card; returns the report entry."""
    import torch
    from cellranger_tpu_torch.align import sw
    from cellranger_tpu_torch.testing.fixtures import sw_inputs

    max_err = 0
    report = {}
    for B in SW_SHAPES:
        args = [torch.from_numpy(a).cuda()
                for a in sw_inputs(B, B, SW_READ_LEN)]
        got = sw.banded_sw(*args)
        torch.cuda.synchronize()
        want = sw.banded_sw_ref(*args)
        for name, g, w in zip(("score", "end_i", "end_d"), got, want):
            err = int((g.long() - w.long()).abs().max())
            max_err = max(max_err, err)
            if err:
                raise AssertionError(f"sw kernel {name} differs at B={B}: "
                                     f"max abs err {err}")
        if B == SW_SHAPES[0]:
            report["ms"] = cuda_time_ms(lambda: sw.banded_sw(*args))
            report["plain_ms"] = cuda_time_ms(
                lambda: sw.banded_sw_ref(*args), reps=20, warmup=2)
    report["max_abs_err"] = max_err
    phase("sw_kernel", f"B={SW_SHAPES} L={SW_READ_LEN}: equal to the plain "
          f"version (max abs err {max_err}); kernel {report['ms']:.4f} ms, "
          f"plain {report['plain_ms']:.4f} ms at B={SW_SHAPES[0]}")
    return report


def _count_cfg(fx: dict, batch_size: int):
    from cellranger_tpu_torch.pipeline.count import CountConfig
    return CountConfig(
        fastq_pairs=[(fx["fq1"], fx["fq2"])], reference_path=fx["ref"],
        whitelist_path=fx["wl"], chemistry="SC3Pv3", read_len=91,
        batch_size=batch_size, secondary_analysis=False, checkpoint=False)


def tiny_parity(tmp: str, devices=("cuda", "cpu"), batch_size: int = 256):
    """The synthetic run on each device: identical outputs; SW launches
    grow on cuda by at least the number of steps and not on cpu."""
    from cellranger_tpu_torch.align import sw
    from cellranger_tpu_torch.pipeline.count import run_count
    from cellranger_tpu_torch.testing.fixtures import build_synthetic_run

    fx = build_synthetic_run(os.path.join(tmp, "tiny"))
    n_steps = -(-fx["n_reads"] // batch_size)
    sums, outs = {}, {}
    for dev in devices:
        before = sw.LAUNCHES
        outs[dev] = os.path.join(tmp, f"tiny_{dev}")
        sums[dev] = run_count(_count_cfg(fx, batch_size), outs[dev],
                              device=dev)
        grew = sw.LAUNCHES - before
        if dev == "cuda" and grew < n_steps:
            raise AssertionError(f"cuda run launched the SW kernel {grew} "
                                 f"times for {n_steps} steps")
        if dev == "cpu" and grew != 0:
            raise AssertionError("cpu run launched the SW kernel")
    a, b = devices
    diffs = [k for k in sorted(set(sums[a]) | set(sums[b]))
             if k != "wall_time_s"
             and json.dumps(sums[a].get(k)) != json.dumps(sums[b].get(k))]
    for sub in ("raw_feature_bc_matrix", "filtered_feature_bc_matrix"):
        for f in ("matrix.mtx.gz", "barcodes.tsv.gz", "features.tsv.gz"):
            with gzip.open(os.path.join(outs[a], sub, f)) as fa, \
                    gzip.open(os.path.join(outs[b], sub, f)) as fb:
                if fa.read() != fb.read():
                    diffs.append(f"{sub}/{f}")
    if diffs:
        raise AssertionError(f"{a} and {b} runs differ: {diffs[:10]}")
    if sums[a]["total_molecules"] != int(fx["truth"].sum()):
        raise AssertionError("tiny run molecule count is off")
    return sums[a], n_steps


def e2e(tmp: str, device: str = "cuda", n_reads: int = E2E_READS,
        batch_size: int = E2E_BATCH) -> dict:
    """The e2e fixture through run_count; returns a result dict."""
    import torch
    from cellranger_tpu_torch.align import sw
    from cellranger_tpu_torch.pipeline.count import H5_OUTPUTS, run_count
    from cellranger_tpu_torch.testing.fixtures import build_e2e_run

    t0 = time.time()
    fx = build_e2e_run(os.path.join(tmp, "e2e"), n_reads=n_reads)
    t_fix = time.time() - t0
    out = os.path.join(tmp, "e2e_out")
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    sw.LAUNCHES = 0                 # count the main path's launches only
    t1 = time.time()
    summary = run_count(_count_cfg(fx, batch_size), out, device=device)
    wall = time.time() - t1
    launches = sw.LAUNCHES
    with open(os.path.join(out, "_perf.json")) as f:
        phases: dict = {}
        for ph in json.load(f)["phases"]:
            phases[ph["name"]] = phases.get(ph["name"], 0.0) + ph["wall_s"]
    return dict(
        reads=summary["total_reads"], wall_s=wall,
        reads_per_s=summary["total_reads"] / wall, fixture_s=t_fix,
        total_molecules=summary["total_molecules"],
        conf_mapped_frac=summary["conf_mapped_frac"],
        estimated_cells=summary["estimated_cells"],
        sw_launches=launches, n_steps=-(-summary["total_reads"]
                                         // batch_size),
        phase_s=phases,
        peak_mem_bytes=(torch.cuda.max_memory_allocated()
                        if device == "cuda" else None),
        h5_skipped=[f for f in H5_OUTPUTS
                    if not os.path.exists(os.path.join(out, f))])


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device (torch.cuda.is_available() "
                 "is false)")
    from cellranger_tpu_torch import kernels   # the port must be here
    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    smi = nvidia_smi_line()
    print(smi, flush=True)
    phase("device", f"{name} sm_{cap[0]}{cap[1]}, torch {torch.__version__}"
          f" cuda {torch.version.cuda}; nvidia-smi: {smi}")

    t = time.time()
    lib = kernels.build()
    phase("build", f"{os.path.relpath(lib)} in {time.time() - t:.3f} s")

    sw_report = check_sw_kernel()

    tmp = tempfile.mkdtemp(prefix="crt_smoke_")
    try:
        s, n_steps = tiny_parity(tmp)
        phase("tiny_parity", f"cuda == cpu over {n_steps} steps: "
              f"{s['total_reads']} reads, {s['total_molecules']} molecules")

        r = e2e(tmp)
        if r["reads"] != E2E_READS:
            raise AssertionError(f"e2e total_reads {r['reads']}")
        if r["total_molecules"] != E2E_TOTAL_MOLECULES:
            raise AssertionError(f"e2e total_molecules "
                                 f"{r['total_molecules']} != "
                                 f"{E2E_TOTAL_MOLECULES}")
        if r["conf_mapped_frac"] != E2E_CONF_MAPPED_FRAC:
            raise AssertionError(f"e2e conf_mapped_frac "
                                 f"{r['conf_mapped_frac']}")
        if r["sw_launches"] < r["n_steps"]:
            raise AssertionError(f"e2e launched the SW kernel "
                                 f"{r['sw_launches']} times in "
                                 f"{r['n_steps']} steps")
        phase("e2e", json.dumps(r))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    print(json.dumps({"kernels": [{
        "name": "banded_sw", "route": "cuda",
        "source": "cellranger_tpu_torch/csrc/sw.cu",
        "replaces": "cellranger_tpu/align/sw.py:131",
        "launches": r["sw_launches"], "max_abs_err": sw_report["max_abs_err"],
        "ms": sw_report["ms"], "plain_ms": sw_report["plain_ms"]}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
