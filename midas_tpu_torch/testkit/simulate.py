"""Synthetic community simulator for hermetic tests.

The reference's test suite requires a 17 GB downloaded database and
asserts only on exit codes (test/test_midas.py:34-37,
assertions at :86-152). We instead generate small databases in the
exact MIDAS on-disk layout (file formats per
midas/build/build_db.py:177-186, 330-346, 397-399) plus reads with
known ground truth, so every pipeline stage can be verified numerically
without any external data.
"""

from __future__ import annotations

import dataclasses
import gzip
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from midas_tpu_torch.db.layout import DEFAULT_MARKER_CUTOFFS
from midas_tpu_torch.io.seqio import decode_seq

MARKER_IDS = sorted(DEFAULT_MARKER_CUTOFFS)  # the 15 PhyEco families

_BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def _rand_seq(rng: np.random.Generator, n: int) -> str:
    return _BASES[rng.integers(0, 4, size=n)].tobytes().decode("ascii")


def _mutate(rng: np.random.Generator, seq: str, divergence: float) -> str:
    """Substitute a fraction of positions (no indels) to create a related
    sequence at ~(1-divergence) identity."""
    arr = np.frombuffer(seq.encode("ascii"), dtype=np.uint8).copy()
    nmut = int(round(divergence * len(arr)))
    if nmut == 0:
        return seq
    pos = rng.choice(len(arr), size=nmut, replace=False)
    shift = rng.integers(1, 4, size=nmut)
    base_idx = np.searchsorted(_BASES, arr[pos])
    arr[pos] = _BASES[(base_idx + shift) % 4]
    return arr.tobytes().decode("ascii")


@dataclasses.dataclass
class SimSpecies:
    species_id: str
    genome_id: str
    contigs: Dict[str, str]                      # contig_id -> seq
    genes: List[dict]                            # feature rows incl. seq
    marker_gene_ids: Dict[str, str]              # marker_id -> gene_id


@dataclasses.dataclass
class SimulatedCommunity:
    species: List[SimSpecies]
    db_dir: str

    def species_ids(self) -> List[str]:
        return [sp.species_id for sp in self.species]


def _make_species(
    rng: np.random.Generator,
    species_num: int,
    genome_len: int,
    gene_len: int,
    n_extra_genes: int,
    base: Optional[SimSpecies] = None,
    divergence: float = 0.0,
) -> SimSpecies:
    sid = f"test_species_{species_num}"
    gid = f"genome_{species_num}"
    if base is not None:
        contig_seqs = [_mutate(rng, s, divergence) for s in base.contigs.values()]
    else:
        # two contigs to exercise multi-contig paths
        n1 = genome_len // 2
        contig_seqs = [_rand_seq(rng, n1), _rand_seq(rng, genome_len - n1)]
    contigs = {f"{gid}_ctg{i+1}": s for i, s in enumerate(contig_seqs)}

    # Lay genes end to end on each contig, alternating strand, leaving
    # intergenic gaps so IGR/CDS annotation paths are both exercised.
    genes: List[dict] = []
    marker_gene_ids: Dict[str, str] = {}
    gene_num = 0
    marker_iter = iter(MARKER_IDS)
    for contig_id, seq in contigs.items():
        pos = 10
        while pos + gene_len + 10 <= len(seq):
            gene_num += 1
            gene_id = f"{gid}.peg.{gene_num}"
            start, end = pos + 1, pos + gene_len  # 1-based inclusive
            strand = "+" if gene_num % 2 else "-"
            sub = seq[start - 1: end]
            gseq = sub if strand == "+" else _revcomp(sub)
            row = {
                "gene_id": gene_id, "scaffold_id": contig_id,
                "start": start, "end": end, "strand": strand,
                "gene_type": "CDS", "seq": gseq,
            }
            genes.append(row)
            marker_id = next(marker_iter, None)
            if marker_id is not None:
                marker_gene_ids[marker_id] = gene_id
            pos += gene_len + 30  # 30bp intergenic gap
    # extra pangenome-only genes (not on the rep genome)
    for _ in range(n_extra_genes):
        gene_num += 1
        genes.append({
            "gene_id": f"{gid}.peg.{gene_num}", "scaffold_id": None,
            "start": 0, "end": 0, "strand": "+", "gene_type": "CDS",
            "seq": _rand_seq(rng, gene_len),
        })
    return SimSpecies(sid, gid, contigs, genes, marker_gene_ids)


_COMP_TABLE = {"A": "T", "T": "A", "G": "C", "C": "G"}


def _revcomp(seq: str) -> str:
    return "".join(_COMP_TABLE.get(b, b) for b in reversed(seq))


def simulate_db(
    out_dir: str,
    n_species: int = 3,
    genome_len: int = 20000,
    gene_len: int = 900,
    n_extra_genes: int = 5,
    related_pairs: int = 1,
    divergence: float = 0.03,
    seed: int = 0,
) -> SimulatedCommunity:
    """Write a MIDAS-layout database of synthetic species.

    The first `related_pairs` species after the base set are mutated
    copies of species 1 at the given divergence, exercising the
    per-marker %id cutoffs and ambiguous-read assignment.
    """
    rng = np.random.default_rng(seed)
    species: List[SimSpecies] = []
    for i in range(n_species):
        species.append(_make_species(rng, i + 1, genome_len, gene_len, n_extra_genes))
    for j in range(related_pairs):
        species.append(
            _make_species(
                rng, n_species + j + 1, genome_len, gene_len, n_extra_genes,
                base=species[0], divergence=divergence,
            )
        )

    os.makedirs(out_dir, exist_ok=True)
    # species_info.txt / genome_info.txt (build_db.py:330-346)
    with open(os.path.join(out_dir, "species_info.txt"), "w") as f:
        f.write("species_id\trep_genome\tcount_genomes\n")
        for sp in species:
            f.write(f"{sp.species_id}\t{sp.genome_id}\t1\n")
    with open(os.path.join(out_dir, "genome_info.txt"), "w") as f:
        f.write("genome_id\tspecies_id\trep_genome\n")
        for sp in species:
            f.write(f"{sp.genome_id}\t{sp.species_id}\t1\n")

    # marker_genes/ (build_db.py:361-399, 458-479)
    mdir = os.path.join(out_dir, "marker_genes")
    os.makedirs(mdir, exist_ok=True)
    with open(os.path.join(mdir, "phyeco.fa"), "w") as fa, \
            open(os.path.join(mdir, "phyeco.map"), "w") as mp:
        mp.write("species_id\tgenome_id\tgene_id\tgene_length\tmarker_id\n")
        for sp in species:
            gene_seqs = {g["gene_id"]: g["seq"] for g in sp.genes}
            for marker_id, gene_id in sorted(sp.marker_gene_ids.items()):
                seq = gene_seqs[gene_id]
                fa.write(f">{gene_id}\n{seq}\n")
                mp.write(f"{sp.species_id}\t{sp.genome_id}\t{gene_id}\t{len(seq)}\t{marker_id}\n")
    with open(os.path.join(mdir, "phyeco.mapping_cutoffs"), "w") as f:
        for marker_id, cutoff in DEFAULT_MARKER_CUTOFFS.items():
            f.write(f"{marker_id}\t{cutoff}\n")

    # pan_genomes/<sp>/ + rep_genomes/<sp>/
    for sp in species:
        pdir = os.path.join(out_dir, "pan_genomes", sp.species_id)
        os.makedirs(pdir, exist_ok=True)
        with open(os.path.join(pdir, "centroids.ffn"), "w") as fa:
            for g in sp.genes:
                fa.write(f">{g['gene_id']}\n{g['seq']}\n")
        with open(os.path.join(pdir, "gene_info.txt"), "w") as f:
            cols = ["gene_id", "genome_id", "gene_length"] + [
                f"centroid_{p}" for p in (99, 95, 90, 85, 80, 75)]
            f.write("\t".join(cols) + "\n")
            for g in sp.genes:
                row = [g["gene_id"], sp.genome_id, str(len(g["seq"]))] + [g["gene_id"]] * 6
                f.write("\t".join(row) + "\n")
        # centroid_functions.txt.gz: first two genes carry EC annotations
        # linked to KEGG compound C00022 (pyruvate) in the packaged
        # cpd_to_enzyme table, so query_by_compound has hits to report
        with gzip.open(os.path.join(pdir, "centroid_functions.txt.gz"),
                       "wt") as f:
            f.write("gene_id\tfunction_id\tontology\n")
            for g, ec in zip(sp.genes[:2], ("4.1.3.22", "4.1.3.25")):
                f.write(f"{g['gene_id']}\t{ec}\tec\n")
            if len(sp.genes) > 2:
                f.write(f"{sp.genes[2]['gene_id']}\tK00001\tkegg\n")
        rdir = os.path.join(out_dir, "rep_genomes", sp.species_id)
        os.makedirs(rdir, exist_ok=True)
        with open(os.path.join(rdir, "genome.fna"), "w") as fa:
            for cid, seq in sp.contigs.items():
                fa.write(f">{cid}\n{seq}\n")
        with open(os.path.join(rdir, "genome.features"), "w") as f:
            f.write("gene_id\tscaffold_id\tstart\tend\tstrand\tgene_type\n")
            for g in sp.genes:
                if g["scaffold_id"] is None:
                    continue
                f.write("\t".join(str(g[c]) for c in
                                  ["gene_id", "scaffold_id", "start", "end", "strand", "gene_type"]) + "\n")
    return SimulatedCommunity(species=species, db_dir=out_dir)


def write_genome_inputs(community: SimulatedCommunity, out_dir: str) -> str:
    """Write the per-genome input layout the DB builder consumes
    (<dir>/<genome_id>/<genome_id>.{fna,ffn,faa} + mapfile), mirroring
    what the reference's build_midas_db.py expects. Returns the mapfile
    path."""
    from midas_tpu_torch.utils import CODON_TABLE

    # any codon per amino acid, for translating gene seqs to proteins
    aa_to_codon = {}
    for codon, aa in CODON_TABLE.items():
        aa_to_codon.setdefault(aa, codon)

    os.makedirs(out_dir, exist_ok=True)
    mapfile = os.path.join(out_dir, "genomes.mapfile")
    with open(mapfile, "w") as mf:
        mf.write("genome_id\tspecies_id\trep_genome\n")
        for sp in community.species:
            mf.write(f"{sp.genome_id}\t{sp.species_id}\t1\n")
            gdir = os.path.join(out_dir, sp.genome_id)
            os.makedirs(gdir, exist_ok=True)
            with open(os.path.join(gdir, f"{sp.genome_id}.fna"), "w") as f:
                for cid, seq in sp.contigs.items():
                    f.write(f">{cid}\n{seq}\n")
            with open(os.path.join(gdir, f"{sp.genome_id}.ffn"), "w") as f:
                for g in sp.genes:
                    f.write(f">{g['gene_id']}\n{g['seq']}\n")
            with open(os.path.join(gdir, f"{sp.genome_id}.faa"), "w") as f:
                for g in sp.genes:
                    prot = _translate_seq(g["seq"])
                    f.write(f">{g['gene_id']}\n{prot}\n")
    return mapfile


def _translate_seq(seq: str) -> str:
    from midas_tpu_torch.utils import CODON_TABLE

    aas = []
    for i in range(0, len(seq) - len(seq) % 3, 3):
        aas.append(CODON_TABLE.get(seq[i: i + 3], "X"))
    return "".join(aas)


def _mutate_read(rng: np.random.Generator, frag: str, read_len: int,
                 error_rate: float, indel_rate: float,
                 variant_rate: float = 0.0) -> Tuple[str, str]:
    """Read model over a fragment with (read_len + slack) bases:

    - sequencing errors at error_rate: substitutions with DEGRADED base
      quality (phred 2-20) at the error positions — exercising the
      reference's baseq filter semantics (snps.py:186-199);
    - biological variants at variant_rate: substitutions at NORMAL
      quality (real strain variation reads don't flag themselves);
    - at most one 1-3bp indel per read with probability indel_rate
      (the fragment slack absorbs deletions);
    - background base quality phred 32-40.

    Returns (read, qual) both read_len long."""
    arr = np.frombuffer(frag.encode("ascii"), dtype=np.uint8).copy()
    if indel_rate > 0 and rng.random() < indel_rate:
        ilen = int(rng.integers(1, 4))
        if rng.random() < 0.5 and len(arr) > ilen + 2:   # deletion
            at = int(rng.integers(1, len(arr) - ilen))
            arr = np.concatenate([arr[:at], arr[at + ilen:]])
        else:                                            # insertion
            at = int(rng.integers(1, len(arr)))
            ins = _BASES[rng.integers(0, 4, size=ilen)]
            arr = np.concatenate([arr[:at], ins, arr[at:]])
    arr = arr[:read_len]
    n = len(arr)
    qual = rng.integers(32, 41, size=n).astype(np.int64)
    for rate, degrade in ((error_rate, True), (variant_rate, False)):
        nmut = int(np.round(rate * n)) if rate > 0 else 0
        if not nmut:
            continue
        pos = rng.choice(n, size=nmut, replace=False)
        shift = rng.integers(1, 4, size=nmut)
        base_idx = np.searchsorted(_BASES, arr[pos])
        arr[pos] = _BASES[(base_idx + shift) % 4]
        if degrade:
            qual[pos] = rng.integers(2, 21, size=nmut)
    read = arr.tobytes().decode("ascii")
    qstr = "".join(chr(33 + int(q)) for q in qual)
    return read, qstr


def simulate_reads(
    community: SimulatedCommunity,
    out_fastq: str,
    n_reads: int = 2000,
    read_len: int = 100,
    abundances: Optional[List[float]] = None,
    error_rate: float = 0.005,
    indel_rate: float = 0.0,
    variant_rate: float = 0.0,
    seed: int = 1,
) -> List[dict]:
    """Sample error-bearing reads from the community's rep genomes.

    Returns per-read truth records: species_id, contig_id, 0-based
    position, strand. Written as gzipped FASTQ with phred 32-40
    qualities degraded (phred 2-20) at substitution-ERROR positions;
    variant_rate adds normal-quality substitutions (biological
    variation); indel_rate adds at most one 1-3bp indel per read.
    With indels off the read covers exactly [pos, pos+read_len) on the
    truth strand; with indels a 3bp fragment slack absorbs deletions
    (minus-strand coverage then shifts by the slack).
    """
    rng = np.random.default_rng(seed)
    nsp = len(community.species)
    if abundances is None:
        abundances = [1.0 / nsp] * nsp
    probs = np.asarray(abundances, dtype=np.float64)
    probs = probs / probs.sum()
    truth: List[dict] = []
    slack = 3 if indel_rate > 0 else 0
    opener = gzip.open if out_fastq.endswith(".gz") else open
    with opener(out_fastq, "wt") as fq:
        for i in range(n_reads):
            sp = community.species[rng.choice(nsp, p=probs)]
            contig_ids = list(sp.contigs)
            cid = contig_ids[rng.integers(len(contig_ids))]
            seq = sp.contigs[cid]
            pos = int(rng.integers(0, len(seq) - read_len - slack + 1))
            frag = seq[pos: pos + read_len + slack]
            strand = "+" if rng.random() < 0.5 else "-"
            if strand == "-":
                frag = _revcomp(frag)
            read, qstr = _mutate_read(rng, frag, read_len, error_rate,
                                      indel_rate, variant_rate)
            name = f"simread.{i}"
            fq.write(f"@{name}\n{read}\n+\n{qstr}\n")
            truth.append({
                "name": name, "species_id": sp.species_id, "contig_id": cid,
                "pos": pos, "strand": strand,
            })
    return truth


def simulate_paired_reads(
    community: SimulatedCommunity,
    out1: str,
    out2: Optional[str] = None,
    n_pairs: int = 1000,
    read_len: int = 100,
    frag_range: Tuple[int, int] = (220, 420),
    abundances: Optional[List[float]] = None,
    error_rate: float = 0.005,
    indel_rate: float = 0.0,
    variant_rate: float = 0.0,
    seed: int = 1,
) -> List[dict]:
    """Mate pairs in fr orientation from rep-genome fragments (the
    input shape bowtie2 -1/-2/--interleaved consumes, reference
    midas/run/genes.py:127-132): mate 1 is the fragment's 5' read_len
    bases, mate 2 the reverse complement of its 3' read_len bases.

    out2=None writes a single interleaved file (--interleaved); else
    /1 mates go to out1 and /2 mates to out2."""
    rng = np.random.default_rng(seed)
    nsp = len(community.species)
    if abundances is None:
        abundances = [1.0 / nsp] * nsp
    probs = np.asarray(abundances, dtype=np.float64)
    probs = probs / probs.sum()
    truth: List[dict] = []
    opener = (lambda p: (gzip.open if p.endswith(".gz") else open)(p, "wt"))
    f1 = opener(out1)
    f2 = f1 if out2 is None else opener(out2)
    try:
        for i in range(n_pairs):
            sp = community.species[rng.choice(nsp, p=probs)]
            contig_ids = list(sp.contigs)
            cid = contig_ids[rng.integers(len(contig_ids))]
            seq = sp.contigs[cid]
            flen = int(rng.integers(frag_range[0], frag_range[1] + 1))
            flen = min(flen, len(seq))
            pos = int(rng.integers(0, len(seq) - flen + 1))
            frag = seq[pos: pos + flen]
            # fragment sequenced from a random strand
            flip = rng.random() < 0.5
            if flip:
                frag = _revcomp(frag)
            m1 = frag[: read_len + 3]
            m2 = _revcomp(frag[-(read_len + 3):])
            r1, q1 = _mutate_read(rng, m1, read_len, error_rate, indel_rate,
                                  variant_rate)
            r2, q2 = _mutate_read(rng, m2, read_len, error_rate, indel_rate,
                                  variant_rate)
            name = f"simpair.{i}"
            f1.write(f"@{name}/1\n{r1}\n+\n{q1}\n")
            f2.write(f"@{name}/2\n{r2}\n+\n{q2}\n")
            truth.append({
                "name": name, "species_id": sp.species_id, "contig_id": cid,
                "pos": pos, "frag_len": flen, "flipped": flip,
            })
    finally:
        f1.close()
        if f2 is not f1:
            f2.close()
    return truth
