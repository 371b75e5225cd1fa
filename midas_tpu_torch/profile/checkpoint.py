"""Accumulator checkpoints: stage resume + crash recovery.

The reference resumes at stage granularity through persisted
intermediates (temp/pangenomes.bam etc., scripts/run_midas.py:506-604).
Our accumulators are plain arrays, so checkpointing is much cheaper
than a BAM: a sliced host snapshot of the device state (see
device_steps.{species,genes,snps}_state_host) plus the stream position,
written atomically every N batches and at end of stream. A rerun with
the same inputs/params restores the state, skips the consumed batches
(the read stream is deterministic), and produces byte-identical output.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional, Tuple

import numpy as np

from midas_tpu_torch import tracing


def fingerprint(**kw) -> str:
    """Stable digest of everything that must match for a checkpoint to
    be resumable: read paths + params + batch geometry."""
    import hashlib

    blob = json.dumps(kw, sort_keys=True, default=str)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def save(path: str, arrays: Dict[str, np.ndarray], meta: Dict) -> None:
    """Atomic save: write sibling tmp, fsync, rename. Traced as the span
    checkpoint.save, over checkpoint.compress (savez_compressed) and
    checkpoint.fsync (flush and fsync), with the counter
    checkpoint.bytes (the file's size)."""
    with tracing.span("checkpoint.save"):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            with tracing.span("checkpoint.compress"):
                np.savez_compressed(f, __meta__=json.dumps(meta), **arrays)
            with tracing.span("checkpoint.fsync"):
                f.flush()
                os.fsync(f.fileno())
        os.replace(tmp, path)
        if tracing.enabled():
            tracing.count("checkpoint.bytes", os.path.getsize(path))


def load_any(path: str) -> Optional[Tuple[Dict[str, np.ndarray], Dict]]:
    """Load a checkpoint regardless of fingerprint (stage-split
    consumers trust the file the way the reference trusts an existing
    temp/*.bam); None if missing/corrupt."""
    if not os.path.isfile(path):
        return None
    try:
        with np.load(path, allow_pickle=False) as z:
            meta = json.loads(str(z["__meta__"]))
            arrays = {k: z[k] for k in z.files if k != "__meta__"}
        return arrays, meta
    except Exception:
        return None


def load(path: str, expect_fingerprint: str
         ) -> Optional[Tuple[Dict[str, np.ndarray], Dict]]:
    """Load a checkpoint if present and its fingerprint matches;
    otherwise None (corrupt/partial/mismatched checkpoints are ignored,
    the run just starts over)."""
    got = load_any(path)
    if got is None or got[1].get("fingerprint") != expect_fingerprint:
        return None
    return got


def load_guarded(path: str, guard: Dict, force: bool = False
                 ) -> Optional[Tuple[Dict[str, np.ndarray], Dict]]:
    """Load for a later-stage consumer (--call_genes / --pileup without
    --align): the stream fingerprint cannot be recomputed (read paths
    are unknown at that stage), but the finalize-relevant parameters —
    filter cutoffs baked into the accumulators at --align time, the
    species list, the pack geometry — MUST match or the stage would
    silently mis-slice / mis-filter (the reference at least verifies the
    right intermediate exists, scripts/run_midas.py:535-566; our
    checkpoints carry the actual parameters, so verify those). force
    downgrades a mismatch to a warning."""
    import sys

    got = load_any(path)
    if got is None:
        return None
    saved = got[1].get("guard")
    if saved is None:
        print(f"Warning: checkpoint {path} predates parameter guards; "
              "cannot verify it matches this invocation", file=sys.stderr)
        return got
    diffs = {k: (saved.get(k), guard[k]) for k in guard
             if saved.get(k) != guard[k]}
    extra = {k: saved[k] for k in saved if k not in guard}
    for k, v in extra.items():
        diffs[k] = (v, None)
    if diffs:
        lines = "\n".join(f"  {k}: checkpoint={a!r} vs current={b!r}"
                          for k, (a, b) in sorted(diffs.items()))
        msg = (f"checkpoint {path} was written with different "
               f"parameters:\n{lines}")
        if not force:
            sys.exit(f"\nError: {msg}\nRerun with --align (or pass "
                     "--force to consume it anyway)\n")
        print(f"Warning (--force): {msg}", file=sys.stderr)
    return got
