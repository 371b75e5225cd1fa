"""Input generators shared by the port's DP tests (numpy only, so the
tests that run on the card need neither JAX nor the JAX package)."""

import numpy as np


def dp_case(seed, P=128, L=64, D=16, n_subs=3, indel=False):
    """(query [P, L] int8, qlens [P] int32, ref [P, L+D-1] int8): reads
    cut from their own window at offset D//2, with 0..n_subs
    substitutions and, with indel=True, a 1-base deletion in every 5th
    read — the generator of tests/test_pallas_sw.py."""
    rng = np.random.default_rng(seed)
    W = L + D - 1
    ref = rng.integers(0, 4, size=(P, W)).astype(np.int8)
    q = np.full((P, L), 4, dtype=np.int8)
    qlens = np.zeros(P, dtype=np.int32)
    for i in range(P):
        n = [L - 20, L - 10, L][i % 3]
        frag = ref[i, D // 2: D // 2 + n].copy()
        k = i % (n_subs + 1)
        if k:
            pos = rng.choice(n, k, replace=False)
            frag[pos] = (frag[pos] + 1) % 4
        if indel and i % 5 == 0:
            frag = np.delete(frag, 12)
        q[i, : len(frag)] = frag
        qlens[i] = len(frag)
    return q, qlens, ref


def qpen_case(seed, q, scoring, n_frac=0.02):
    """Quality penalties from random Phred scores (bowtie2 --mp table,
    as pipeline.quality_penalties) for reads q, and a copy of q with a
    fraction of read bases turned into N (code 4), so the read-N and
    quality branches of the qpen model are both exercised."""
    rng = np.random.default_rng(seed)
    quals = rng.integers(2, 41, size=q.shape)
    mx, mn = -scoring.mismatch, scoring.mm_min
    qpen = (mn + ((mx - mn) * np.minimum(quals, 40)) // 40).astype(np.int8)
    qn = q.copy()
    qn[(rng.random(q.shape) < n_frac) & (q < 4)] = 4
    return qpen, qn
