"""Profile-HMM search: a native replacement for the hmmsearch step of
the reference DB build (midas/build/build_db.py:401-407, which shells
out to HMMER3 over each genome's protein file).

Implements: HMMER3 ASCII (.hmm) parsing and a uni-local Viterbi
log-odds scorer vectorized over profile states (numpy), with e-values
from the file's own STATS LOCAL VITERBI gumbel parameters. This covers
the reference's use case — picking the best-scoring protein per marker
family with an e-value cutoff (find_hits, build_db.py:422-433) — not
the full HMMER feature surface.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

AMINO = "ACDEFGHIKLMNPQRSTVWY"
AA_INDEX = {a: i for i, a in enumerate(AMINO)}

# Background amino-acid frequencies (HMMER's null model; standard
# Swiss-Prot-derived composition)
BG_FREQ = np.array([
    0.0787945, 0.0151600, 0.0535222, 0.0668298, 0.0397062, 0.0695071,
    0.0229198, 0.0590092, 0.0594422, 0.0963728, 0.0237718, 0.0414386,
    0.0482904, 0.0395639, 0.0540978, 0.0683364, 0.0540687, 0.0673417,
    0.0114135, 0.0304133,
])


@dataclasses.dataclass
class ProfileHMM:
    name: str
    length: int
    match_logodds: np.ndarray   # [M+1, 20] log2-odds (row 0 unused)
    tr: np.ndarray              # [M+1, 7] ln transition probs (mm mi md im ii dm dd)
    viterbi_mu: Optional[float] = None
    viterbi_lambda: Optional[float] = None


def parse_hmm_file(path: str) -> List[ProfileHMM]:
    """Parse all models from a HMMER3 ASCII file."""
    models = []
    with open(path) as f:
        lines = iter(f)
        while True:
            model = _parse_one(lines)
            if model is None:
                break
            models.append(model)
    return models


def _parse_one(lines: Iterator[str]) -> Optional[ProfileHMM]:
    name = None
    length = None
    vit_mu = vit_lambda = None
    for line in lines:
        tok = line.split()
        if not tok:
            continue
        if tok[0] == "NAME":
            name = tok[1]
        elif tok[0] == "LENG":
            length = int(tok[1])
        elif tok[0] == "STATS" and len(tok) >= 5 and tok[2] == "VITERBI":
            vit_mu, vit_lambda = float(tok[3]), float(tok[4])
        elif tok[0] == "HMM":
            break
    else:
        return None
    if name is None or length is None:
        return None
    next(lines)  # transition header line
    M = length
    match_nlp = np.zeros((M + 1, 20))
    tr_nlp = np.full((M + 1, 7), np.inf)
    # node 0: optional COMPO line + insert emissions + transitions
    line = next(lines)
    if line.split() and line.split()[0] == "COMPO":
        next(lines)            # node-0 insert emissions
        line0 = next(lines)    # node-0 transitions
    else:
        line0 = next(lines)
    tr_nlp[0] = _floats7(line0)
    for node in range(1, M + 1):
        m_line = next(lines).split()
        assert int(m_line[0]) == node, (m_line[0], node)
        match_nlp[node] = [_nlp(x) for x in m_line[1:21]]
        next(lines)            # insert emissions
        tr_nlp[node] = _floats7(next(lines))
    # consume to record end
    for line in lines:
        if line.startswith("//"):
            break
    match_logodds = (-match_nlp - np.log(BG_FREQ)[None, :]) / math.log(2.0)
    return ProfileHMM(
        name=name, length=M, match_logodds=match_logodds, tr=-tr_nlp,
        viterbi_mu=vit_mu, viterbi_lambda=vit_lambda)


def _nlp(x: str) -> float:
    return math.inf if x == "*" else float(x)


def _floats7(line: str) -> np.ndarray:
    return np.array([_nlp(x) for x in line.split()[:7]])


def encode_protein(seq: str) -> np.ndarray:
    return np.array([AA_INDEX.get(a, -1) for a in seq.upper()], dtype=np.int32)


def viterbi_score(hmm: ProfileHMM, protein: str) -> float:
    """Uni-local Viterbi bit score of a protein vs the profile.

    Local alignment: free entry to any match state (HMMER local entry
    ~ log(2/(M*(M+1))) per state, approximated uniform), free exit from
    any match state. Emissions are log2-odds vs the background; insert
    emissions score 0 (HMMER convention)."""
    x = encode_protein(protein)
    x = x[x >= 0]
    Lp = len(x)
    M = hmm.length
    if Lp == 0:
        return -np.inf
    ln2 = math.log(2.0)
    emis = hmm.match_logodds[1:, :]        # [M, 20] bits
    tr = hmm.tr / ln2                      # bits
    t_mm, t_mi, t_md = tr[:, 0], tr[:, 1], tr[:, 2]
    t_im, t_ii = tr[:, 3], tr[:, 4]
    t_dm, t_dd = tr[:, 5], tr[:, 6]
    entry = math.log2(2.0 / (M * (M + 1)))
    NEG = -1e30
    Vm = np.full(M, NEG)
    Vi = np.full(M, NEG)
    Vd = np.full(M, NEG)
    best = NEG
    # transition vectors aligned so index s receives state s (node s+1)
    tm = np.concatenate(([NEG], t_mm[1:M]))
    ti = np.concatenate(([NEG], t_im[1:M]))
    td = np.concatenate(([NEG], t_dm[1:M]))
    # delete-chain prefix pieces (all clamped: -inf transitions become a
    # large finite penalty so prefix sums/differences stay NaN-free):
    #   C[node] = sum of D->D transitions up to that node
    BIGNEG = -1e4
    dd = np.clip(t_dd[1: M + 1], BIGNEG, None)
    md = np.clip(t_md[1: M + 1], BIGNEG, None)
    C = np.concatenate(([0.0], np.cumsum(dd)))   # [M+1], node-indexed
    for t in range(Lp):
        e = emis[:, x[t]]
        m_prev = np.concatenate(([NEG], Vm[:-1]))
        i_prev = np.concatenate(([NEG], Vi[:-1]))
        d_prev = np.concatenate(([NEG], Vd[:-1]))
        Vm_new = e + np.maximum.reduce([
            m_prev + tm, i_prev + ti, d_prev + td,
            np.full(M, entry),
        ])
        Vi_new = np.maximum(Vm + t_mi[1: M + 1], Vi + t_ii[1: M + 1])
        # deletes consume no residue: within this column,
        #   Vd[s] = C[s] + max_{j'<=s-1}( Vm_new[j'] + t_md[j'+1] - C[j'+1] )
        # closed-form via an exclusive prefix max (same trick as the
        # aligner's deletion scan)
        A = Vm_new + md - C[1: M + 1]
        pref = np.maximum.accumulate(A)
        Vd_new = np.concatenate(([NEG], C[1:M] + pref[:-1]))
        Vm, Vi, Vd = Vm_new, Vi_new, Vd_new
        best = max(best, float(Vm.max()))
    return best


def evalue(hmm: ProfileHMM, score_bits: float, n_targets: int) -> float:
    if hmm.viterbi_mu is None or hmm.viterbi_lambda is None:
        return math.exp(-score_bits)  # crude fallback
    p = math.exp(-hmm.viterbi_lambda * (score_bits - hmm.viterbi_mu))
    return n_targets * min(p, 1.0)


def search_proteins(
    hmms: List[ProfileHMM],
    proteins: Dict[str, str],
    max_evalue: float = 1e-5,
) -> Dict[str, Tuple[str, float, float]]:
    """Best hit per family: family name -> (protein_id, bits, evalue).
    Mirrors find_hits' best-per-target semantics (build_db.py:422-433)."""
    hits: Dict[str, Tuple[str, float, float]] = {}
    n = len(proteins)
    for hmm in hmms:
        best = None
        for pid, seq in proteins.items():
            s = viterbi_score(hmm, seq)
            ev = evalue(hmm, s, n)
            if ev > max_evalue:
                continue
            if best is None or ev < best[2]:
                best = (pid, s, ev)
        if best is not None:
            hits[hmm.name] = best
    return hits
