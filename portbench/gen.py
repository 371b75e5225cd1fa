"""The benchmark's generator: a MIDAS-layout database and a sample of
reads, both from the run's seed, from the parameters of a configuration
file (configs/<name>.json, its "database" group) and of a traffic file
(workloads/<name>.json).

The database follows the port's testkit simulator (testkit/simulate.py:
two contigs a genome, genes of gene_len laid end to end 30 bp apart on
alternating strands, the first 15 of each genome its PhyEco marker
genes, extra genes only in the pangenome, related species as copies of
species 1 with substitutions), built with array operations. The reads
follow its read model: 100 bp from a random strand, at most one 1-3 bp
indel in indel_rate of reads (3 bp of fragment slack), phred 32-40, and
substitution errors with phred 2-20 at their positions; errors are drawn
base by base at error_rate (the testkit rounds error_rate * read_len to
a whole number of errors a read, which is 0 at 0.5% of 100 bp). Mate
pairs are in fr orientation from fragments of frag_range bp.

Every species of a source group gets the same number of reads, so every
seed gives the same sizes in another order.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import os
import zlib
from typing import Dict, List

import numpy as np

MARKER_CUTOFFS = {
    "B000032": 95.50, "B000039": 94.75, "B000041": 98.00, "B000062": 97.25,
    "B000063": 96.00, "B000065": 98.00, "B000071": 95.25, "B000079": 98.00,
    "B000080": 95.25, "B000081": 97.00, "B000082": 95.25, "B000086": 96.75,
    "B000096": 96.75, "B000103": 95.25, "B000114": 94.50,
}
MARKER_IDS = sorted(MARKER_CUTOFFS)
ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)
_CODE = np.zeros(256, dtype=np.uint8)
_CODE[ACGT] = np.arange(4, dtype=np.uint8)
_COMP = bytes.maketrans(b"ACGT", b"TGCA")
GAP = 30          # intergenic bases
SLACK = 3         # fragment bases beyond the read, absorbing deletions
CHUNK = 1 << 17   # reads drawn at a time
# the per-species database parts each path reads
DB_PARTS = {"species": (), "genes": ("pan_genomes",),
            "snps": ("rep_genomes",)}


@dataclasses.dataclass
class Species:
    species_id: str
    genome_id: str
    contigs: List[np.ndarray]          # uint8 ASCII bases
    genes: List[dict]                  # gene_id, contig, start, end, strand, seq
    markers: Dict[str, str]            # marker_id -> gene_id


def _bases(rng, n: int) -> np.ndarray:
    return ACGT[rng.integers(0, 4, size=n)]


def _revcomp(seq: bytes) -> bytes:
    return seq.translate(_COMP)[::-1]


def _mutate(rng, arr: np.ndarray, rate: float) -> np.ndarray:
    """A copy with round(rate * len) positions substituted."""
    out = arr.copy()
    n = int(round(rate * len(arr)))
    if n:
        pos = rng.choice(len(arr), size=n, replace=False)
        out[pos] = ACGT[(_CODE[out[pos]] + rng.integers(1, 4, size=n)) % 4]
    return out


def _species(rng, num: int, p: Dict, base: "Species" = None) -> Species:
    gid = f"genome_{num}"
    if base is not None:
        contigs = [_mutate(rng, c, p["divergence"]) for c in base.contigs]
    else:
        n1 = p["genome_len"] // 2
        contigs = [_bases(rng, n1), _bases(rng, p["genome_len"] - n1)]
    genes, markers = [], {}
    gl = p["gene_len"]
    marker_iter = iter(MARKER_IDS)
    k = 0
    for ci, seq in enumerate(contigs):
        raw = seq.tobytes()
        pos = 10
        while pos + gl + 10 <= len(seq):
            k += 1
            strand = "+" if k % 2 else "-"
            sub = raw[pos: pos + gl]
            genes.append(dict(gene_id=f"{gid}.peg.{k}", contig=ci,
                              start=pos + 1, end=pos + gl, strand=strand,
                              seq=sub if strand == "+" else _revcomp(sub)))
            m = next(marker_iter, None)
            if m is not None:
                markers[m] = genes[-1]["gene_id"]
            pos += gl + GAP
    for _ in range(p["n_extra_genes"]):
        k += 1
        genes.append(dict(gene_id=f"{gid}.peg.{k}", contig=None, start=0,
                          end=0, strand="+", seq=_bases(rng, gl).tobytes()))
    return Species(f"test_species_{num}", gid, contigs, genes, markers)


def make_db(out_dir: str, p: Dict, seed: int,
            parts=("pan_genomes", "rep_genomes")) -> List[Species]:
    """Write a MIDAS-layout database of p["n_species"] random species and
    p["related_pairs"] copies of species 1 at p["divergence"]; returns
    the species. The marker genes and species tables are always written;
    of the per-species parts only those named in `parts` (the others'
    directories stay empty: a path reads only its own)."""
    rng = np.random.default_rng([seed, 0])
    species = [_species(rng, i + 1, p) for i in range(p["n_species"])]
    species += [_species(rng, p["n_species"] + j + 1, p, base=species[0])
                for j in range(p["related_pairs"])]
    os.makedirs(os.path.join(out_dir, "marker_genes"), exist_ok=True)
    with open(os.path.join(out_dir, "species_info.txt"), "w") as f:
        f.write("species_id\trep_genome\tcount_genomes\n")
        f.writelines(f"{s.species_id}\t{s.genome_id}\t1\n" for s in species)
    with open(os.path.join(out_dir, "genome_info.txt"), "w") as f:
        f.write("genome_id\tspecies_id\trep_genome\n")
        f.writelines(f"{s.genome_id}\t{s.species_id}\t1\n" for s in species)
    with open(os.path.join(out_dir, "marker_genes/phyeco.fa"), "wb") as fa, \
            open(os.path.join(out_dir, "marker_genes/phyeco.map"), "w") as mp:
        mp.write("species_id\tgenome_id\tgene_id\tgene_length\tmarker_id\n")
        for s in species:
            seqs = {g["gene_id"]: g["seq"] for g in s.genes}
            for m, gene_id in sorted(s.markers.items()):
                fa.write(b">" + gene_id.encode() + b"\n" + seqs[gene_id] + b"\n")
                mp.write(f"{s.species_id}\t{s.genome_id}\t{gene_id}\t"
                         f"{len(seqs[gene_id])}\t{m}\n")
    with open(os.path.join(out_dir, "marker_genes/phyeco.mapping_cutoffs"),
              "w") as f:
        f.writelines(f"{m}\t{c}\n" for m, c in MARKER_CUTOFFS.items())
    for d in ("pan_genomes", "rep_genomes"):
        os.makedirs(os.path.join(out_dir, d), exist_ok=True)
    for s in species:
        pdir = os.path.join(out_dir, "pan_genomes", s.species_id)
        rdir = os.path.join(out_dir, "rep_genomes", s.species_id)
        if "pan_genomes" in parts:
            _write_pangenome(pdir, s)
        if "rep_genomes" in parts:
            _write_rep_genome(rdir, s)
    return species


def _write_pangenome(pdir: str, s: Species) -> None:
    os.makedirs(pdir, exist_ok=True)
    with open(os.path.join(pdir, "centroids.ffn"), "wb") as fa:
        fa.write(b"".join(b">" + g["gene_id"].encode() + b"\n" + g["seq"]
                          + b"\n" for g in s.genes))
    with open(os.path.join(pdir, "gene_info.txt"), "w") as f:
        f.write("\t".join(["gene_id", "genome_id", "gene_length"]
                          + [f"centroid_{c}" for c in
                             (99, 95, 90, 85, 80, 75)]) + "\n")
        f.writelines("\t".join([g["gene_id"], s.genome_id,
                                str(len(g["seq"]))] + [g["gene_id"]] * 6)
                     + "\n" for g in s.genes)


def _write_rep_genome(rdir: str, s: Species) -> None:
    os.makedirs(rdir, exist_ok=True)
    with open(os.path.join(rdir, "genome.fna"), "wb") as fa:
        for ci, c in enumerate(s.contigs):
            fa.write(f">{s.genome_id}_ctg{ci + 1}\n".encode()
                     + c.tobytes() + b"\n")
    with open(os.path.join(rdir, "genome.features"), "w") as f:
        f.write("gene_id\tscaffold_id\tstart\tend\tstrand\tgene_type\n")
        f.writelines(f"{g['gene_id']}\t{s.genome_id}_ctg{g['contig'] + 1}"
                     f"\t{g['start']}\t{g['end']}\t{g['strand']}\tCDS\n"
                     for g in s.genes if g["contig"] is not None)


def pick_species(spec, species: List[Species], selected: List[str]
                 ) -> List[Species]:
    """The species a spec names: "first:N", "selected", "others" (the
    database's species not selected), or a list of ids."""
    if isinstance(spec, list):
        by_id = {s.species_id: s for s in species}
        return [by_id[i] for i in spec]
    if spec.startswith("first:"):
        return species[: int(spec.split(":")[1])]
    if spec == "selected":
        return [s for s in species if s.species_id in selected]
    if spec == "others":
        return [s for s in species if s.species_id not in selected]
    raise ValueError(f"unknown species spec {spec!r}")


def _source_genome(rng, s: Species, group: Dict) -> np.ndarray:
    """The genome a species' reads come from: its contigs, joined; with
    strain_snp_rate, a strain of it with that share of sites carrying
    one other allele; with genome_len, set at a random offset in random
    bases of that length."""
    g = np.concatenate(s.contigs)
    rate = group.get("strain_snp_rate", 0.0)
    if rate:
        g = _mutate(rng, g, rate)
    n = int(group.get("genome_len") or 0)
    if n > len(g):
        out = _bases(rng, n)
        at = int(rng.integers(0, n - len(g) + 1))
        out[at: at + len(g)] = g
        g = out
    return g


def _reads(rng, frags: np.ndarray, read_len: int, t: Dict):
    """The read model over [N, read_len + SLACK] fragments: (bases [N,
    read_len] uint8 ASCII, phred+33 [N, read_len] uint8)."""
    N, F = frags.shape
    bases = frags[:, :read_len].copy()
    rows = np.flatnonzero(rng.random(N) < t["indel_rate"])
    if len(rows):
        ilen = rng.integers(1, 4, size=len(rows))
        dele = rng.random(len(rows)) < 0.5
        j = np.arange(read_len)[None, :]
        d_at = rng.integers(1, F - ilen)            # deletion point
        i_at = rng.integers(1, F, size=len(rows))   # insertion point
        at = np.where(dele, d_at, i_at)[:, None]
        il = ilen[:, None]
        cols = np.where(dele[:, None], np.where(j < at, j, j + il),
                        np.where(j < at, j, j - il))
        ins = ~dele[:, None] & (j >= at) & (j < at + il)
        sub = np.take_along_axis(frags[rows], cols, axis=1)
        sub[ins] = _bases(rng, int(ins.sum()))
        bases[rows] = sub
    qual = rng.integers(32, 41, size=(N, read_len), dtype=np.uint8)
    err = rng.random((N, read_len), dtype=np.float32) < t["error_rate"]
    n_err = int(err.sum())
    if n_err:
        bases[err] = ACGT[(_CODE[bases[err]]
                           + rng.integers(1, 4, size=n_err)) % 4]
        qual[err] = rng.integers(2, 21, size=n_err, dtype=np.uint8)
    return bases, qual + 33


def _fragments(rng, genome: np.ndarray, n: int, length: np.ndarray,
               width: int) -> np.ndarray:
    """n fragments of the given lengths from random positions of the
    genome, on a random strand, first `width` bases of each (revcomp
    for the minus strand taken after cutting)."""
    start = rng.integers(0, len(genome) - length + 1)
    idx = start[:, None] + np.arange(width)[None, :]
    frag = genome[np.minimum(idx, len(genome) - 1)]
    flip = rng.random(n) < 0.5
    if flip.any():
        # the minus strand's first `width` bases: the complement of the
        # fragment's last `width`, reversed
        end = start + length
        ridx = np.maximum(end[:, None] - 1 - np.arange(width)[None, :], 0)
        rc = _comp_codes(genome[ridx[flip]])
        frag[flip] = rc
    return frag


def _comp_codes(a: np.ndarray) -> np.ndarray:
    return np.frombuffer(a.tobytes().translate(_COMP),
                         dtype=np.uint8).reshape(a.shape)


def _write_fastq(path: str, bases: np.ndarray, qual: np.ndarray,
                 prefix: bytes, suffix: bytes = b"") -> None:
    """Fixed-width 4-line records, "@<prefix><8 digits><suffix>",
    gzipped at level 1 as a few concatenated members."""
    N, L = bases.shape
    name = 1 + len(prefix) + 8 + len(suffix)
    width = name + 1 + L + 3 + L + 1
    rec = np.empty((N, width), dtype=np.uint8)
    rec[:, 0] = ord("@")
    rec[:, 1: 1 + len(prefix)] = np.frombuffer(prefix, np.uint8)
    i = np.arange(N)
    for d in range(8):
        rec[:, 1 + len(prefix) + d] = 48 + (i // 10 ** (7 - d)) % 10
    if suffix:
        rec[:, name - len(suffix): name] = np.frombuffer(suffix, np.uint8)
    rec[:, name] = 10
    rec[:, name + 1: name + 1 + L] = bases
    rec[:, name + 1 + L: name + 4 + L] = np.frombuffer(b"\n+\n", np.uint8)
    rec[:, name + 4 + L: name + 4 + 2 * L] = qual
    rec[:, -1] = 10
    # one gzip member a part, compressed on threads (zlib releases the
    # GIL); readers take concatenated members as one stream
    parts = max(1, min(8, os.cpu_count() or 1))
    step = -(-N // parts)

    def member(lo):
        z = zlib.compressobj(1, zlib.DEFLATED, 31)
        return z.compress(rec[lo: lo + step].tobytes()) + z.flush()
    with concurrent.futures.ThreadPoolExecutor(parts) as ex:
        members = list(ex.map(member, range(0, N, step)))
    with open(path, "wb") as f:
        for m in members:
            f.write(m)


def make_sample(out_dir: str, species: List[Species], selected: List[str],
                t: Dict, seed: int) -> Dict:
    """Write the sample a traffic file describes; returns its read
    files, whether they are mate pairs, the reads a file holds, and the
    source genomes ((species id, bases) each)."""
    rng = np.random.default_rng([seed, 1])
    n = int(t["reads"])
    groups = []
    for g in t["sources"]:
        members = pick_species(g["species"], species, selected)
        groups.append((g, members))
    counts = []
    for g, members in groups:
        total = int(round(g["share"] * n))
        per = np.full(len(members), total // len(members))
        per[: total - per.sum()] += 1
        counts.append(per)
    flat = np.concatenate(counts)
    flat[-1] += n - flat.sum()
    ids = [s.species_id for _g, ms in groups for s in ms]
    genomes = [_source_genome(rng, s, g) for g, ms in groups for s in ms]
    L = int(t["read_len"])
    paired = bool(t.get("paired"))
    lo, hi = t.get("frag_range", (L + SLACK, L + SLACK))
    parts = {1: [], 2: []}
    for genome, total in zip(genomes, flat):
        for k in [CHUNK] * (total // CHUNK) + [total % CHUNK]:
            if not k:
                continue
            length = rng.integers(lo, hi + 1, size=k) if paired \
                else np.full(k, L + SLACK)
            length = np.minimum(length, len(genome))
            frag = _fragments(rng, genome, k, length, int(length.max()))
            parts[1].append(_reads(rng, frag[:, : L + SLACK], L, t))
            if paired:
                # mate 2: the reverse complement of the fragment's 3' end
                end = length[:, None] - 1 - np.arange(L + SLACK)[None, :]
                m2 = _comp_codes(np.take_along_axis(frag, end, axis=1))
                parts[2].append(_reads(rng, m2, L, t))
    order = rng.permutation(n)
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for mate in (1, 2) if paired else (1,):
        bases = np.concatenate([p[0] for p in parts[mate]])[order]
        qual = np.concatenate([p[1] for p in parts[mate]])[order]
        path = os.path.join(out_dir, f"sample_{mate}.fq.gz")
        _write_fastq(path, bases, qual, b"p" if paired else b"r",
                     f"/{mate}".encode() if paired else b"")
        paths.append(path)
    return dict(paths=paths, paired=paired, reads=n,
                sources=list(zip(ids, genomes)))
