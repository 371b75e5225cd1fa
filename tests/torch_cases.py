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


def tie_case(seed, P=128, L=64, D=16):
    """(query, qlens, ref) like dp_case, but with windows where many band
    offsets score alike: homopolymers, di- and trinucleotide repeats, and
    random windows around a long homopolymer run. Reads are cut at a
    random offset, with substitutions, 1-3 bp insertions or deletions and
    read Ns, so row maxima, deletion-scan keys and their ties land on
    every offset. The first pairs hold an empty and a 1 bp read."""
    rng = np.random.default_rng(seed)
    W = L + D - 1
    ref = np.empty((P, W), dtype=np.int8)
    q = np.full((P, L), 4, dtype=np.int8)
    qlens = np.zeros(P, dtype=np.int32)
    for i in range(P):
        kind = i % 4
        if kind == 3:
            ref[i] = rng.integers(0, 4, W)
            a = int(rng.integers(0, W // 2))
            ref[i, a:a + W // 2] = rng.integers(0, 4)
        else:
            unit = rng.integers(0, 4, size=kind + 1)
            ref[i] = np.resize(unit, W)
            noise = rng.random(W) < 0.03
            ref[i, noise] = rng.integers(0, 4, int(noise.sum()))
        n = int(rng.integers(L // 2, L + 1))
        at = int(rng.integers(0, D))
        frag = ref[i, at:at + n].copy()
        k = int(rng.integers(0, 4))
        if k:
            pos = rng.choice(len(frag), k, replace=False)
            frag[pos] = (frag[pos] + rng.integers(1, 4, k)) % 4
        g = int(rng.integers(1, 4))
        c = int(rng.integers(4, len(frag) - 4))
        if i % 3 == 1:
            frag = np.delete(frag, range(c, c + g))
        elif i % 3 == 2:
            frag = np.insert(frag, c, rng.integers(0, 4, g))[:L]
        frag[rng.random(len(frag)) < 0.01] = 4
        q[i, :len(frag)] = frag
        qlens[i] = len(frag)
    qlens[:2] = (0, 1)
    return q, qlens, ref


def long_bucket_case(seed, L, scoring, P=48, read_len=256, D=16):
    """(query [P, L], qlens, ref [P, L+D-1], qpen [P, L]): dp_case reads
    of at most read_len bp, with indels, reference Ns, an empty, a 1 bp
    and a full-length read, and qpen_case penalties and read Ns, padded
    into an L-row bucket (query with N, reference and qpen with random
    tails). The bucket L, not the reads, routes a kernel launch, and
    short reads keep the plain version's row loop short."""
    q0, qlens, ref0 = dp_case(seed, P=P, L=read_len, D=D, indel=True)
    rng = np.random.default_rng(seed + 1)
    ref0[rng.random(ref0.shape) < 0.01] = 4
    qlens[:3] = (0, 1, read_len)
    qpen0, q0 = qpen_case(seed + 2, q0, scoring)
    q = np.full((P, L), 4, dtype=np.int8)
    q[:, :read_len] = q0
    ref = rng.integers(0, 4, size=(P, L + D - 1)).astype(np.int8)
    ref[:, :read_len + D - 1] = ref0
    qpen = rng.integers(2, 7, size=(P, L)).astype(np.int8)
    qpen[:, :read_len] = qpen0
    return q, qlens, ref, qpen


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
