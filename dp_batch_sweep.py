#!/usr/bin/env python3
"""Time the genes path's two banded-DP calls at small batches on one
NVIDIA card: K3 with qpen (pass 1, 4 candidates a read) and K2 (pass 2,
one row a read), under LOCAL and GLOBAL scoring, for batches of 256 to
8,192 reads. A run's last batch and short CLI runs are that small.

    python3 dp_batch_sweep.py [--root DIR] [--label NAME]

--root picks the checkout whose midas_tpu_torch is timed (default: this
script's own), so that two checkouts can be compared on one card by
running the script once per checkout in turns. Inputs are the same in
every checkout: 100 bp reads cut from their window in a 128-row bucket,
1% substitutions, a 1 bp deletion in every 7th read, penalties and read
Ns from tests/torch_cases.py's qpen_case. Each call is checked equal to
the plain version field by field, then timed by CUDA events (mean of 20
launches after a warm-up, three turns). Prints one JSON line per shape.
"""

import argparse
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
READS = (256, 1024, 2048, 4096, 8192)
CANDS, L, READ_LEN, D = 4, 128, 100, 16


def _torch_cases():
    spec = importlib.util.spec_from_file_location(
        "torch_cases", os.path.join(HERE, "tests", "torch_cases.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def genes_pairs(seed, P, scoring):
    """(query, qlens, ref, qpen) of P genes-shaped pairs, numpy."""
    rng = np.random.default_rng(seed)
    ref = rng.integers(0, 4, size=(P, L + D - 1)).astype(np.int8)
    q = np.full((P, L), 4, dtype=np.int8)
    q[:, :READ_LEN] = ref[:, D // 2:D // 2 + READ_LEN]
    sub = rng.random((P, READ_LEN)) < 0.01
    q[:, :READ_LEN][sub] = (q[:, :READ_LEN][sub] + 1) % 4
    qlens = np.full(P, READ_LEN, dtype=np.int32)
    q[::7, 50:READ_LEN - 1] = q[::7, 51:READ_LEN]
    q[::7, READ_LEN - 1] = 4
    qlens[::7] = READ_LEN - 1
    qpen, q = _torch_cases().qpen_case(seed + 1, q, scoring)
    return q, qlens, ref, qpen


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--label", default=None)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    from midas_tpu_torch.align import cuda_sw
    from midas_tpu_torch.align.banded import banded_align_plain
    from midas_tpu_torch.align.params import GLOBAL_SCORING, LOCAL_SCORING

    if not torch.cuda.is_available():
        sys.exit("dp_batch_sweep: needs an NVIDIA card")
    assert cuda_sw.__file__.startswith(root + os.sep), cuda_sw.__file__
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    cuda_sw.load_library()
    label = args.label or root
    for sname, sc in (("local", LOCAL_SCORING), ("global", GLOBAL_SCORING)):
        for n in READS:
            for key, P, so in (("K3_qpen", CANDS * n, True),
                               ("K2", n, False)):
                q, ql, ref, qpen = (torch.from_numpy(a).cuda()
                                    for a in genes_pairs(n, P, sc))

                def kern():
                    return cuda_sw.banded_align_cuda(q, ql, ref, sc,
                                                     qpen=qpen, score_only=so)

                got = kern()
                want = banded_align_plain(q, ql, ref, sc, qpen=qpen,
                                          score_only=so)
                for k in want:
                    if not torch.equal(got[k], want[k]):
                        sys.exit(f"dp_batch_sweep: {key} {sname} P={P}: "
                                 f"field {k} differs from the plain version")
                turns = []
                for _ in range(3):
                    kern()
                    torch.cuda.synchronize()
                    a = torch.cuda.Event(enable_timing=True)
                    b = torch.cuda.Event(enable_timing=True)
                    a.record()
                    for _ in range(20):
                        kern()
                    b.record()
                    b.synchronize()
                    turns.append(a.elapsed_time(b) / 20)
                print(json.dumps(dict(
                    tree=label, variant=key, scoring=sname, reads=n, P=P,
                    ms=float(np.mean(turns)), turns_ms=turns, equal=True,
                    card=smi)), flush=True)


if __name__ == "__main__":
    main()
