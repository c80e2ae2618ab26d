"""Phase checkpoint/resume for pipeline runs — the pipestance-resume
analog (SURVEY §5.4: Martian journals each stage's durable outputs and
`mrp` restarts a failed pipeline by skipping completed stages;
lib/rust/cr_wrap surfaces that via run IDs).

Here the expensive phase is the two-pass extract/correct/align/dedup
sweep over the FASTQs; its durable product is the deduplicated molecule
table (barcode, feature, umi, reads) + the streaming metric counters.
`CountCheckpoint` persists that state under `<out_dir>/_checkpoint/`
keyed by a fingerprint of the inputs (config fields + FASTQ sizes), so
a rerun into the same output directory with unchanged inputs skips
straight to matrix assembly / cell calling / secondary analysis, while
any input change invalidates the checkpoint. Writes are atomic
(tmp + rename) so a crash mid-save never leaves a corrupt manifest.

Verbatim copy of cellranger_tpu/pipeline/checkpoint.py: the port keeps its own copy of
every jax-free module it needs and imports nothing of that package.
"""

from __future__ import annotations

import hashlib
import json
import os

import numpy as np

VERSION = 1


def count_fingerprint(cfg) -> str:
    """Stable hash of everything that determines the molecule table."""
    libs = cfg.libraries or []
    pairs = list(cfg.fastq_pairs or []) + [
        p for l in libs for p in l.fastq_pairs]
    files = []
    for r1, r2 in pairs:
        for p in (r1, r2):
            if p is None:
                continue
            st = os.stat(p)
            files.append((os.path.abspath(p), st.st_size, int(st.st_mtime)))
    key = dict(
        version=VERSION,
        chemistry=cfg.chemistry, read_len=cfg.read_len,
        batch_size=cfg.batch_size, gem_group=cfg.gem_group,
        reference_path=cfg.reference_path, probe_set_csv=cfg.probe_set_csv,
        feature_ref_csv=cfg.feature_ref_csv,
        whitelist_path=cfg.whitelist_path,
        probe_barcode_csv=cfg.probe_barcode_csv,
        library_types=[l.library_type for l in libs],
        files=sorted(files))
    return hashlib.sha256(
        json.dumps(key, sort_keys=True).encode()).hexdigest()


class CountCheckpoint:
    def __init__(self, out_dir: str, fingerprint: str):
        self.dir = os.path.join(out_dir, "_checkpoint")
        self.fingerprint = fingerprint
        self._manifest_path = os.path.join(self.dir, "manifest.json")

    def _manifest(self) -> dict | None:
        try:
            with open(self._manifest_path) as f:
                m = json.load(f)
        except (OSError, ValueError):
            return None
        if m.get("fingerprint") != self.fingerprint \
                or m.get("version") != VERSION:
            return None
        return m

    def load(self, phase: str) -> dict | None:
        """Returns the phase's saved arrays + meta dict, or None if the
        checkpoint is absent or stale."""
        m = self._manifest()
        if m is None or phase not in m.get("phases", {}):
            return None
        path = os.path.join(self.dir, m["phases"][phase])
        try:
            with np.load(path, allow_pickle=False) as z:
                out = {k: z[k] for k in z.files if k != "__meta__"}
        except (OSError, ValueError):
            return None
        meta_path = path + ".meta.json"
        try:
            with open(meta_path) as f:
                out["__meta__"] = json.load(f)
        except (OSError, ValueError):
            out["__meta__"] = {}
        return out

    def save(self, phase: str, arrays: dict, meta: dict | None = None):
        os.makedirs(self.dir, exist_ok=True)
        fname = f"{phase}.npz"
        path = os.path.join(self.dir, fname)
        tmp = path + ".tmp.npz"
        np.savez_compressed(tmp, **arrays)
        os.replace(tmp, path)
        with open(path + ".meta.json.tmp", "w") as f:
            json.dump(meta or {}, f, default=float)
        os.replace(path + ".meta.json.tmp", path + ".meta.json")
        m = self._manifest() or dict(fingerprint=self.fingerprint,
                                     version=VERSION, phases={})
        m["phases"][phase] = fname
        with open(self._manifest_path + ".tmp", "w") as f:
            json.dump(m, f, indent=2)
        os.replace(self._manifest_path + ".tmp", self._manifest_path)
