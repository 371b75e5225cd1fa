"""Greedy centroid clustering of gene sequences — the role vsearch
-cluster_fast plays in the reference DB build
(midas/build/build_db.py:204-213: cluster at 99%, then re-cluster the
centroids at 95/90/85/80/75%).

Algorithm (UCLUST-style star clustering): process sequences longest
first; estimate identity to existing centroids from shared k-mer
containment (Mash-style ANI estimate); join the first centroid above
the identity threshold, else found a new cluster. The k-mer screen is
vectorized over centroids via a k-mer -> centroid inverted index, so
each query only scores centroids it shares seeds with.

This is a build-time (offline) path; identity here is an estimate of
average nucleotide identity, which is what gene-family clustering
needs — not base-exact alignment identity.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np

from midas_tpu_torch.db.index import EMPTY_KEY, pack_kmers
from midas_tpu_torch.io.seqio import encode_seq


def _kmer_set(seq_codes: np.ndarray, k: int) -> np.ndarray:
    km = pack_kmers(seq_codes, k)
    km = km[km != EMPTY_KEY]
    return np.unique(km)


def _ani_from_containment(c: float, k: int) -> float:
    """Mash-style identity estimate from k-mer containment c."""
    if c <= 0:
        return 0.0
    if c >= 1:
        return 1.0
    # P(kmer intact) ~ ani^k  =>  ani ~ c^(1/k)
    return c ** (1.0 / k)


def greedy_cluster(
    names: Sequence[str],
    seqs: Sequence[str],
    identity: float,
    k: int = 12,
) -> Dict[str, str]:
    """Cluster sequences at the given fractional identity (e.g. 0.99).

    Returns mapping name -> centroid name (centroids map to themselves).
    """
    order = sorted(range(len(seqs)), key=lambda i: -len(seqs[i]))
    centroid_of: Dict[str, str] = {}
    centroid_kmers: List[np.ndarray] = []
    centroid_names: List[str] = []
    # inverted index: kmer -> centroid ids (grown incrementally)
    inv: Dict[int, List[int]] = {}
    for i in order:
        codes = encode_seq(seqs[i].upper())
        kms = _kmer_set(codes, k)
        best_c, best_ani = -1, 0.0
        if len(kms):
            # vote: count shared kmers per centroid
            counts: Dict[int, int] = {}
            for km in kms:
                for c in inv.get(int(km), ()):
                    counts[c] = counts.get(c, 0) + 1
            for c, shared in counts.items():
                denom = min(len(kms), len(centroid_kmers[c]))
                ani = _ani_from_containment(shared / max(denom, 1), k)
                if ani > best_ani:
                    best_ani, best_c = ani, c
        if best_c >= 0 and best_ani >= identity:
            centroid_of[names[i]] = centroid_names[best_c]
        else:
            cid = len(centroid_names)
            centroid_names.append(names[i])
            centroid_kmers.append(kms)
            centroid_of[names[i]] = names[i]
            for km in kms:
                inv.setdefault(int(km), []).append(cid)
    return centroid_of


def cluster_levels(
    names: Sequence[str],
    seqs: Sequence[str],
    levels: Sequence[int] = (99, 95, 90, 85, 80, 75),
    k: int = 12,
) -> Dict[int, Dict[str, str]]:
    """Reference semantics (build_db.py:127-175): cluster all genes at
    99%, then cluster the 99% centroids at each lower level; every gene
    maps to a centroid at every level transitively."""
    seq_by_name = dict(zip(names, seqs))
    maps: Dict[int, Dict[str, str]] = {}
    c99 = greedy_cluster(names, seqs, identity=0.99, k=k)
    maps[99] = c99
    centroids99 = sorted(set(c99.values()), key=list(names).index)
    for pid in levels:
        if pid == 99:
            continue
        sub = greedy_cluster(
            centroids99, [seq_by_name[n] for n in centroids99],
            identity=pid / 100.0, k=k)
        maps[pid] = {name: sub[c99[name]] for name in names}
    return maps
