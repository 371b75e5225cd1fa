"""Alignment scoring models.

The reference delegates scoring to two black boxes whose *outputs* feed
its filters: HS-BLASTN (megablast scoring; %id + aln length + bitscore
ranking, midas/run/species.py:64-85) and Bowtie2 (end-to-end and local
presets; NM tag and MAPQ feed keep_read, midas/run/genes.py:153-169,
snps.py:141-162). We define three explicit scoring personalities with
the same downstream contract:

- MARKER_SCORING: megablast (reward 1 / penalty -2 with LINEAR gap
  costs of 2.5 per gap column, scaled x2 to stay integer: match 2,
  mismatch -4, open 0, extend 5), bitscore + e-value via
  Karlin-Altschul (lambda halved for the scaling). Drives species
  profiling exactly like the reference's m8 parsing.
- GLOBAL_SCORING: bowtie2 end-to-end-like (all penalties <= 0, perfect
  read scores 0, min score -0.6-0.6*L). Drives SNP pileup mapping.
- LOCAL_SCORING: bowtie2 local-like (match bonus +2, min score
  20+8*ln(L)). Drives pangenome CNV mapping.
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class ScoringParams:
    match: int
    mismatch: int          # negative; with qual_scaled this is -MX (the
    #                        worst-quality penalty; bowtie2 --mp MX,MN)
    gap_open: int          # positive cost; a gap of length g costs open + g*extend
    gap_extend: int        # positive cost
    mode: str              # 'local' (free query+ref ends) or 'glocal' (full query, free ref ends)
    # Karlin-Altschul parameters for e-value/bitscore (marker personality).
    ka_lambda: float = 1.28
    ka_k: float = 0.46
    # Bowtie2 quality-scaled mismatch model (bowtie2 manual, --mp MX,MN,
    # default 6,2): the penalty for a mismatch at a base with Phred
    # quality Q is  MN + floor((MX-MN) * MIN(Q, 40.0) / 40.0),  and a
    # column whose READ base is an ambiguous character costs n_pen
    # (--np, default 1). Deviation, documented: a column whose REF base
    # is code 4 with a real read base costs MX, not n_pen — the packed
    # reference uses one code for both N and structural padding
    # (window/guard pad must stay maximally penalized), and rep-genome
    # Ns are assembly gaps no kept read should span. qual_scaled=False
    # (megablast marker personality) keeps the flat `mismatch` for
    # every non-match, as before.
    qual_scaled: bool = False
    mm_min: int = 2
    n_pen: int = 1

    def mismatch_penalty(self, q: int) -> int:
        """Positive penalty for a mismatch at Phred quality q —
        bowtie2's MM penalty table, computed in exact integer
        arithmetic: MN + ((MX-MN) * min(q, 40)) // 40."""
        if not self.qual_scaled:
            return -self.mismatch
        mx = -self.mismatch
        return self.mm_min + ((mx - self.mm_min) * min(int(q), 40)) // 40

    def score_min(self, read_len: int) -> float:
        """Minimum acceptable alignment score, bowtie2-style defaults:
        end-to-end: -0.6 - 0.6*L ; local: 20 + 8*ln(L)."""
        if self.mode == "glocal":
            return -0.6 - 0.6 * read_len
        return 20.0 + 8.0 * math.log(read_len)

    def score_perfect(self, read_len: int) -> float:
        return float(self.match * read_len)

    def bitscore(self, raw: float) -> float:
        return (self.ka_lambda * raw - math.log(self.ka_k)) / math.log(2.0)

    def evalue(self, raw: float, qlen: int, dblen: int) -> float:
        return float(qlen) * float(dblen) * 2.0 ** (-self.bitscore(raw))

    def evalue_score_threshold(self, qlen, dblen: float,
                               emax: float = 1e-3):
        """Smallest raw score whose e-value is <= emax — the score-space
        form of hs-blastn's `-evalue 1e-3` gate (the reference's m8 is
        pre-thresholded by the binary, midas/run/species.py:39-46).
        Monotone algebra of evalue(): raw >= (ln K + ln qlen + ln dblen
        - ln emax) / lambda. Immaterial for reads >= ~25 bp (the
        pid-cutoff + qcov floors imply higher scores), but our k=14
        seed index can align ultra-short fragments the binary's 28 bp
        word size never would — this gate drops them identically.
        Works on scalars or numpy arrays, in float64."""
        import numpy as _np

        return (_np.log(self.ka_k) + _np.log(_np.asarray(qlen, _np.float64))
                + (_np.log(dblen) - _np.log(emax))) / self.ka_lambda

    def evalue_min_score(self, qlen, dblen: float, emax: float = 1e-3):
        """The e-value gate as an integer minimum score per read length:
        ceil(evalue_score_threshold). DP scores are integers, so
        `score >= thr` and `score >= ceil(thr)` are the same test, and
        an integer table makes the gate independent of how a device
        rounds its float log. Returns int64 numpy values."""
        import numpy as _np

        return _np.ceil(self.evalue_score_threshold(qlen, dblen, emax)
                        ).astype(_np.int64)


# megablast scoring for the 15-marker-gene search. hs-blastn runs with
# NCBI megablast defaults (the reference passes no scoring flags,
# midas/run/species.py:39-46): reward 1, penalty -2, and the greedy
# aligner's LINEAR gap cost of reward/2 - penalty = 2.5 per gap column
# (no opening cost). Everything is scaled x2 to stay integer (match 2,
# mismatch -4, extend 5); ka_lambda halves to compensate, so bitscores
# and e-values match the binary's. The affine open=2/extend=1 model
# used before round 4 preferred gapped extensions megablast rejects
# (first seen as a best-hit set divergence on 150 bp indel reads).
MARKER_SCORING = ScoringParams(match=2, mismatch=-4, gap_open=0,
                               gap_extend=5, mode="local",
                               ka_lambda=0.64, ka_k=0.46)

# bowtie2 end-to-end scoring (rep-genome SNP mapping default,
# run_midas.py:404 mode default 'global'; the reference invokes bowtie2
# with default scoring, midas/run/snps.py:97-128): match 0, mismatch
# quality-scaled --mp 6,2, gaps --rdg/--rfg 5,3, read-N --np 1
GLOBAL_SCORING = ScoringParams(match=0, mismatch=-6, gap_open=5,
                               gap_extend=3, mode="glocal",
                               qual_scaled=True, mm_min=2, n_pen=1)

# bowtie2 local scoring (pangenome CNV mapping default,
# run_midas.py:269 mode default 'local'; reference invocation
# midas/run/genes.py:116-145): match bonus --ma 2, quality-scaled
# mismatch --mp 6,2, gaps 5,3, read-N --np 1
LOCAL_SCORING = ScoringParams(match=2, mismatch=-6, gap_open=5,
                              gap_extend=3, mode="local",
                              qual_scaled=True, mm_min=2, n_pen=1)


# Bowtie2 MapqV2 decision tables (bowtie2 mapq.h, class MapqV2::mapq —
# public source; the same tree is reproduced in the widely-cited
# "How does bowtie2 assign MAPQ scores?" analysis). Each unique-branch
# row is (bestOver/diff threshold, mapq); each tie-branch row is
# (bestdiff/diff threshold, mapq@perfect, mapq@>=0.84, mapq@>=0.68,
# mapq@else) where single-valued bands repeat the value. The reference
# pipeline consumes the result through its mapq>=20 SNP gate
# (scripts/run_midas.py:413, midas/run/snps.py:141-162).
_MAPQ_UNIQ_E2E = ((0.8, 42), (0.7, 40), (0.6, 24), (0.5, 23), (0.4, 8),
                  (0.3, 3))
_MAPQ_UNIQ_E2E_FLOOR = 0
_MAPQ_UNIQ_LOCAL = ((0.8, 44), (0.7, 42), (0.6, 41), (0.5, 36), (0.4, 28),
                    (0.3, 24))
_MAPQ_UNIQ_LOCAL_FLOOR = 22
# tie branch: rows for bestdiff >= 0.9..0.1 of diff (descending), then
# the bestdiff>0 pair and the bestdiff==0 pair (vs bestOver >= 0.67*diff)
_MAPQ_TIE_E2E = (
    (0.9, 39, 33, 33, 33),
    (0.8, 38, 27, 27, 27),
    (0.7, 37, 26, 26, 26),
    (0.6, 36, 22, 22, 22),
    (0.5, 35, 25, 16, 5),
    (0.4, 34, 21, 14, 4),
    (0.3, 32, 18, 10, 3),
    (0.2, 31, 17, 9, 2),
    (0.1, 30, 15, 8, 1),
)
_MAPQ_TIE_E2E_TAIL = ((6, 2), (1, 0))     # (bestdiff>0), (bestdiff==0)
_MAPQ_TIE_LOCAL = (
    (0.9, 40, 40, 40, 40),
    (0.8, 39, 39, 39, 39),
    (0.7, 33, 33, 33, 33),
    (0.6, 30, 30, 30, 30),
    (0.5, 27, 25, 20, 20),
    (0.4, 26, 19, 15, 15),
    (0.3, 23, 17, 11, 11),
    (0.2, 21, 14, 8, 8),
    (0.1, 19, 13, 6, 6),
)
_MAPQ_TIE_LOCAL_TAIL = ((5, 3), (2, 1))


# Bowtie2 evaluates these thresholds as `intScore >= diff * (double)0.Xf`:
# scMin/scMax/best/secbest are INTEGER scores (TAlScore; SimpleFunc's
# value is cast, truncating toward zero), diff is an integer, and the
# band fraction is a single-precision literal widened to double — so
# e.g. the 0.6 boundary sits at diff * 0.60000002384185791, and an
# integer bestOver exactly equal to 0.6*diff falls BELOW it. We keep
# the fractions as their f32-cast doubles for exact parity.
def _f32(x: float) -> float:
    import numpy as np

    return float(np.float32(x))


def score_min_int(score_min: float) -> int:
    """Bowtie2's scMin as it enters MAPQ: the score-min function value
    cast to the integer score type (C++ double->int64 truncates toward
    zero): -60.6 -> -60, 20 + 8*ln(L) -> trunc."""
    return int(score_min)  # python int() truncates toward zero


def mapq_from_scores(best: float, second: float, score_min: float,
                     score_perfect: float, has_second: bool,
                     local: bool = False) -> int:
    """Bowtie2 MapqV2 MAPQ, transcribed from bowtie2's mapq.h
    (MapqV2::mapq; end-to-end 'monotone' tree when local=False, local
    tree when local=True).

    Semantics as in the source: scMin truncates to an integer score;
    diff = max(scMax - scMin, 1) (integers); a second-best alignment
    only counts when its score is itself valid (>= scMin); bestdiff =
    |abs(best) - abs(secbest)|; band thresholds compare integer scores
    against diff times the f32-cast band fractions (see _f32 note).
    The tie branch bands on bestdiff deciles with bestOver sub-bands at
    ==diff, >= 0.84*diff, >= 0.68*diff (0.67*diff in the two tail
    bands). Transition tests: tests/test_checkpoint.py."""
    smin = score_min_int(score_min)
    if best < smin:
        return 0
    diff = max(int(round(score_perfect)) - smin, 1)
    best_over = int(round(best)) - smin
    if not (has_second and second >= smin):
        table = _MAPQ_UNIQ_LOCAL if local else _MAPQ_UNIQ_E2E
        floor = _MAPQ_UNIQ_LOCAL_FLOOR if local else _MAPQ_UNIQ_E2E_FLOOR
        for frac, q in table:
            if best_over >= _f32(frac) * diff:
                return q
        return floor
    bestdiff = abs(abs(int(round(best))) - abs(int(round(second))))
    rows = _MAPQ_TIE_LOCAL if local else _MAPQ_TIE_E2E
    tail = _MAPQ_TIE_LOCAL_TAIL if local else _MAPQ_TIE_E2E_TAIL
    perfect = best_over == diff
    for frac, q_perfect, q84, q68, q_else in rows:
        if bestdiff >= _f32(frac) * diff:
            if perfect:
                return q_perfect
            if best_over >= _f32(0.84) * diff:
                return q84
            if best_over >= _f32(0.68) * diff:
                return q68
            return q_else
    hi = best_over >= _f32(0.67) * diff
    if bestdiff > 0:
        return tail[0][0] if hi else tail[0][1]
    return tail[1][0] if hi else tail[1][1]
