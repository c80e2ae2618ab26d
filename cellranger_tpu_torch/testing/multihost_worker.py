"""One host of a multi-host count: joins the process group named by the
CRTPU_* variables (parallel/distributed.py) and runs the production
run_count over a shared output directory.  Host 0 writes the joined
outputs; every other host publishes its spill and partial and returns.

    CRTPU_COORDINATOR=localhost:29500 CRTPU_NUM_PROCESSES=2 \\
    CRTPU_PROCESS_ID=0 python -m cellranger_tpu_torch.testing.multihost_worker \\
        cfg.json out_dir --device cuda

cfg.json holds CountConfig's fields.  The last line of standard output
is one JSON object: this host's pid, the reads it reports (host 0: the
run's; the others: their own lanes'), its SW kernel launches and, on the
card, its peak device memory.  `launch` starts P such processes on this
machine over a free local port and waits for them.
"""

import argparse
import json
import os
import socket
import subprocess
import sys
import time


def main(argv=None) -> None:
    # the process group comes up before the pipeline is imported, as a
    # production launcher would sequence it
    from ..parallel import distributed as dist
    dist.init_from_env()
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("cfg")
    p.add_argument("out_dir")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    a = p.parse_args(argv)
    import torch
    from ..align import sw
    from ..pipeline.count import CountConfig, run_count

    with open(a.cfg) as f:
        d = json.load(f)
    d["fastq_pairs"] = [tuple(x) for x in d["fastq_pairs"]]
    if a.device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    s = run_count(CountConfig(**d), a.out_dir, device=a.device)
    print(json.dumps({
        "pid": dist.process_index(), "total_reads": s["total_reads"],
        "sw_launches": sw.LAUNCHES,
        "peak_mem_bytes": (torch.cuda.max_memory_allocated()
                           if a.device == "cuda" else None)}), flush=True)
    if dist.process_count() > 1:
        torch.distributed.destroy_process_group()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch(cfg: dict, out_dir: str, n_procs: int, device: str = "cpu",
           timeout: float = 300.0, env: dict | None = None,
           module: str | None = None) -> list[dict]:
    """Run one worker per host id 0..n_procs-1 on this machine, joined
    over a free local port, on `cfg` (CountConfig fields) and `out_dir`;
    the worker is `python -m module` (default: this module), run from the
    repository's root.
    Every process is killed when the run exceeds `timeout` seconds (then
    TimeoutError) or when this function leaves early.  Returns, in host
    order, dict(rc, out: the last stdout line's JSON or None, stderr
    tail)."""
    os.makedirs(out_dir, exist_ok=True)
    cfg_path = os.path.join(out_dir, "_hosts_cfg.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    port = free_port()
    procs, logs = [], []
    try:
        for pid in range(n_procs):
            penv = dict(os.environ, **(env or {}),
                        CRTPU_COORDINATOR=f"localhost:{port}",
                        CRTPU_NUM_PROCESSES=str(n_procs),
                        CRTPU_PROCESS_ID=str(pid))
            so = open(os.path.join(out_dir, f"_host{pid}.out"), "w+b")
            se = open(os.path.join(out_dir, f"_host{pid}.err"), "w+b")
            logs.append((so, se))
            procs.append(subprocess.Popen(
                [sys.executable, "-m", module or __spec__.name, cfg_path,
                 out_dir, "--device", device],
                cwd=root, env=penv, stdout=so, stderr=se))
        deadline = time.time() + timeout
        while any(p.poll() is None for p in procs):
            if time.time() > deadline:
                raise TimeoutError(f"{n_procs} hosts still running after "
                                   f"{timeout} s")
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    res = []
    for p, (so, se) in zip(procs, logs):
        so.seek(0)
        se.seek(0)
        lines = so.read().decode().strip().splitlines()
        so.close()
        err = se.read().decode()[-3000:]
        se.close()
        try:
            out = json.loads(lines[-1]) if lines else None
        except ValueError:
            out = None
        res.append(dict(rc=p.returncode, out=out, err=err))
    return res


if __name__ == "__main__":
    sys.exit(main())
