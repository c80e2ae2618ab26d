"""Time the banded Smith-Waterman kernel on the card, alone or against
another source of it.

    python3 -m cellranger_tpu_torch.testing.sw_timing [--against other_sw.cu]
                                                      [--out out.json]

`time_on_device` and `time_calls` are the two clocks chip_smoke.py reads
the kernel with: the device time of a launch (CUDA events around a CUDA
graph of back-to-back launches) and the time of one eager call, host side
included.  Run as a script, this times `align.sw.banded_sw` at the main
path's shapes, needs one CUDA device and prints one JSON object with the
card's name and power limit; `--out` names a file to write it to.

`--against` names another source of the kernel that exports
`crt_banded_sw` with the same ten arguments: an earlier commit's
(`git show <commit>:cellranger_tpu_torch/csrc/sw.cu` into a file under
build/), or a copy of csrc/sw.cu with another lane split (CPL, THREADS) or
another scan.  It is compiled with the port's nvcc flags, held against the
plain torch version (all three outputs equal on every row) and timed in
turns with the port's kernel (other, current, current, other) inside this
one call, because two calls may land on two cards.  The lane splits and
scans that the kernel's design rejected were timed this way.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys

SHAPES = ((8192, 91), (2048, 91), (8192, 150))
LAUNCHES_PER_SAMPLE = 10
SAMPLES = 20


def _event_samples(fn, samples: int, divide_by: int) -> dict:
    import torch

    times = []
    for _ in range(samples):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / divide_by)
    return dict(ms=statistics.median(times), min_ms=min(times),
                max_ms=max(times))


def time_on_device(fn, samples: int = SAMPLES,
                   per_sample: int = LAUNCHES_PER_SAMPLE) -> dict:
    """Device time of one fn() in ms.  `per_sample` calls are captured in
    a CUDA graph, so that a replay runs them back to back with no host
    work between them (the wrapper's host side takes longer than a short
    kernel); each sample brackets one replay with CUDA events and is
    divided by the number of calls.  Median, minimum and maximum of the
    samples, after warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per_sample):
            fn()
    for _ in range(3):
        graph.replay()
    torch.cuda.synchronize()
    return _event_samples(graph.replay, samples, per_sample)


def time_calls(fn, samples: int = SAMPLES, warmup: int = 3) -> dict:
    """CUDA-event time of single eager calls of fn() in ms, host side
    included: what one call costs a caller that waits for it."""
    for _ in range(warmup):
        fn()
    return _event_samples(fn, samples, 1)


def both_clocks(fn) -> dict:
    t = time_on_device(fn)
    t["call_ms"] = time_calls(fn)["ms"]
    return t


def load_other(cu_path: str):
    """Compile another sw.cu with the port's nvcc flags; returns a function
    of the four input tensors like `align.sw.banded_sw`."""
    import torch
    from .. import kernels

    so = os.path.join(kernels.BUILD_DIR, "libcrt_sw_other.so")
    os.makedirs(kernels.BUILD_DIR, exist_ok=True)
    subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", so, cu_path],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(so)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.crt_banded_sw.argtypes = [p, p, p, p, i, i, p, p, p, p]
    lib.crt_banded_sw.restype = i

    def launch(*args):
        B, L = args[0].shape
        outs = torch.empty((3, B), dtype=torch.int32, device=args[0].device)
        rc = lib.crt_banded_sw(
            *(t.data_ptr() for t in args), B, L,
            *(o.data_ptr() for o in outs.unbind(0)),
            torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"other kernel: CUDA error {rc}")
        return outs.unbind(0)

    return launch


def main() -> None:
    import torch
    from .. import kernels
    from ..align import sw
    from .fixtures import sw_inputs

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out")
    ap.add_argument("--against")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("sw_timing: no CUDA device")
    kernels.build()
    other = load_other(opts.against) if opts.against else None
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    report = dict(card=smi, ptxas=[ln for ln in kernels.BUILD_LOG.splitlines()
                                   if "registers" in ln or "spill" in ln],
                  by_shape={})
    for B, L in SHAPES:
        args = [torch.from_numpy(a).cuda() for a in sw_inputs(B, B, L)]
        want = sw.banded_sw_ref(*args)
        turns = [("current", sw.banded_sw)]
        if other is not None:
            turns = [("other", other), *turns * 2, ("other", other)]
        rows = []
        for name, launch in turns:
            for g, w in zip(launch(*args), want):
                if not torch.equal(g, w):
                    raise AssertionError(f"{name} kernel differs from the "
                                         f"plain version at B={B} L={L}")
            rows.append({name: both_clocks(lambda: launch(*args))})
        report["by_shape"][f"{B}x{L}"] = rows
    text = json.dumps(report)
    print(text)
    if opts.out:
        with open(opts.out, "w") as f:
            f.write(text)


if __name__ == "__main__":
    main()
