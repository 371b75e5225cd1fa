"""Pairwise gene-content distances — scripts/compare_genes.py:60-145
semantics: jaccard/euclidean/manhattan on the copynum matrix (or the
presence/absence matrix derived via a copy-number cutoff)."""

from __future__ import annotations

import itertools
from typing import Dict, List, Optional

import numpy as np

from midas_tpu_torch.io.seqio import parse_file


def load_copynum(path: str, max_genes: Optional[int] = None,
                 max_samples: Optional[int] = None):
    """genes_copynum.txt -> (gene_ids, sample_ids, matrix [G, S])."""
    gene_ids: List[str] = []
    rows: List[List[float]] = []
    sample_ids: Optional[List[str]] = None
    for r in parse_file(path):
        if sample_ids is None:
            sample_ids = [k for k in r if k != "gene_id"]
            if max_samples:
                sample_ids = sample_ids[:max_samples]
        gene_ids.append(r["gene_id"])
        rows.append([float(r[s]) for s in sample_ids])
        if max_genes and len(gene_ids) >= max_genes:
            break
    return gene_ids, sample_ids or [], np.asarray(rows, dtype=np.float64)


def compare_genes(
    indir: str,
    out: str,
    dtype: str = "copynum",           # 'copynum' | 'presabs'
    distance: str = "jaccard",        # 'jaccard' | 'euclidean' | 'manhattan'
    cutoff: float = 0.35,
    max_genes: Optional[int] = None,
    max_samples: Optional[int] = None,
) -> None:
    gene_ids, sample_ids, data = load_copynum(
        f"{indir}/genes_copynum.txt", max_genes, max_samples)
    if dtype == "presabs":
        data = (data > cutoff).astype(np.float64)
    with open(out, "w") as f:
        f.write("\t".join(["sample1", "sample2", "count1", "count2",
                           "count_both", "count_either", "distance"]) + "\n")
        for i, j in itertools.combinations(range(len(sample_ids)), 2):
            a, b = data[:, i], data[:, j]
            if dtype == "presabs":
                count1 = int((a == 1).sum())
                count2 = int((b == 1).sum())
                count_both = int(((a == 1) & (b == 1)).sum())
                count_either = int(((a == 1) | (b == 1)).sum())
            else:
                # mirrors the reference exactly, including its quirk of
                # summing sample2 for both counts (compare_genes.py:132-133)
                # and its builtin-sum SEQUENTIAL float accumulation
                # (np.sum's pairwise reduction differs in the last ulp)
                count1 = float(sum(b.tolist()))
                count2 = float(sum(b.tolist()))
                count_both = float(sum(np.minimum(a, b).tolist()))
                count_either = float(sum(np.maximum(a, b).tolist()))
            if distance == "jaccard":
                d = 1 - (float(count_both) / count_either) if count_either > 0 else 0
            elif distance == "euclidean":
                d = float(np.sqrt(sum(((a - b) ** 2).tolist())))
            else:
                d = float(sum(np.abs(a - b).tolist()))
            f.write("\t".join(str(x) for x in [
                sample_ids[i], sample_ids[j], count1, count2,
                count_both, count_either, d]) + "\n")
