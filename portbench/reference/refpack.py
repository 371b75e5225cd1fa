"""Packed reference arrays — the TPU-native replacement for
bowtie2-build / `hs-blastn index` FM-indexes
(midas/run/genes.py:108-114, snps.py:89-95,
midas/build/build_db.py:449-456).

All target sequences (marker genes, pangenome centroids, or rep-genome
contigs) are concatenated into one flat int8 code array that lives in
HBM. Per-sequence offsets let alignment candidates be mapped from a
global pack coordinate back to (sequence, local position), and window
gathers are masked at sequence boundaries so alignments never cross
targets.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

from portbench.reference.seqio import PAD_CODE, encode_seq, iopen, read_fastx

GUARD = 64  # sentinel bases appended at the very end for safe clamped gathers


@dataclasses.dataclass
class ReferencePack:
    """Flat packed reference ready for device upload."""

    codes: np.ndarray        # [G + GUARD] int8, concatenated sequences
    offsets: np.ndarray      # [S + 1] int64, sequence i spans [offsets[i], offsets[i+1])
    names: List[str]         # [S]
    lengths: np.ndarray      # [S] int32
    # Optional per-sequence annotation columns (e.g. species index for
    # pangenome packs, marker family index for the marker pack).
    meta: Dict[str, np.ndarray] = dataclasses.field(default_factory=dict)

    @property
    def num_seqs(self) -> int:
        return len(self.names)

    @property
    def total_len(self) -> int:
        return int(self.offsets[-1])

def build_pack(
    records: Iterable[Tuple[str, str]],
    meta_fn=None,
) -> ReferencePack:
    """Build a ReferencePack from (name, sequence) records.

    meta_fn, if given, maps a record name to a dict of scalar annotations;
    values are collected into per-key int32/float32 columns.
    """
    names: List[str] = []
    chunks: List[np.ndarray] = []
    lengths: List[int] = []
    meta_rows: List[dict] = []
    for name, seq in records:
        names.append(name)
        codes = encode_seq(seq.upper())
        chunks.append(codes)
        lengths.append(len(codes))
        if meta_fn is not None:
            meta_rows.append(meta_fn(name))
    if not names:
        raise ValueError("build_pack: no sequences")
    offsets = np.zeros(len(names) + 1, dtype=np.int64)
    np.cumsum(lengths, out=offsets[1:])
    codes = np.concatenate(chunks + [np.full(GUARD, PAD_CODE, dtype=np.int8)])
    meta: Dict[str, np.ndarray] = {}
    if meta_rows:
        for key in meta_rows[0]:
            col = [row[key] for row in meta_rows]
            if isinstance(col[0], float):
                meta[key] = np.asarray(col, dtype=np.float32)
            else:
                meta[key] = np.asarray(col, dtype=np.int32)
    return ReferencePack(
        codes=codes,
        offsets=offsets,
        names=names,
        lengths=np.asarray(lengths, dtype=np.int32),
        meta=meta,
    )


def pack_from_fasta(paths, meta_fn=None) -> ReferencePack:
    """Build a pack straight from FASTA file(s)."""
    if isinstance(paths, str):
        paths = [paths]

    def gen():
        for path in paths:
            with iopen(path) as fp:
                for name, seq, _q in read_fastx(fp):
                    yield name, seq

    return build_pack(gen(), meta_fn=meta_fn)
