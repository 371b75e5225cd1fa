"""Cross-sample SNP merger / multi-sample SNP caller —
midas/merge/snps.py re-designed around vectorized chunks.

The reference streams N open .snps.gz files in lock step, bounded by
RLIMIT_NOFILE (utility.batch_samples), forks a pool per sample batch to
build count matrices, then forks again over line ranges to call SNPs
(snps.py:246-407). Here the same pipeline is chunked numpy: per-site
allele counts for all samples load in fixed-size blocks, pooled calls /
per-sample MAFs / prevalence are array ops, and only passing sites take
the per-site annotation path (the reference's gene-sweep, :116-174,
reproduced exactly).

Semantics preserved:
- major/minor = top-2 pooled frequencies, ties broken in A,C,G,T order
  (call_alleles :49-76)
- snp_type mono/bi/tri/quad by rarest allele freq >= allele_freq (:70-76)
- per-sample depth counts only major+minor reads (:78-91)
- prevalence: site_depth and site_ratio vs the sample's genome-wide
  mean coverage (:93-104)
- output: snps_info.txt (NA for missing), snps_freq.txt ({:.3g} mafs),
  snps_depth.txt; site_id = 1-based global site index (:176-200)
"""

from __future__ import annotations

import os
import shutil
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from midas_tpu_torch.db.layout import Database
from midas_tpu_torch.io.seqio import iopen
from midas_tpu_torch.merge.core import SpeciesGroup, select_species
from midas_tpu_torch.utils import index_replace, translate

CHUNK_SITES = 200_000
ALLELES = ["A", "C", "G", "T"]


def _open_sample_files(sp: SpeciesGroup, samples=None) -> List:
    files = []
    for sample in (sp.samples if samples is None else samples):
        path = os.path.join(sample.dir, "snps/output", f"{sp.id}.snps.gz")
        f = iopen(path)
        next(f)  # header
        files.append(f)
    return files


def _read_chunk(files: List, max_rows: int):
    """Read up to max_rows lock-step rows from every sample file.

    Returns (site_meta [rows of (ref_id, ref_pos, ref_allele)],
    counts [S, rows, 4] int64) or None at EOF."""
    per_sample_counts = []
    site_meta = None
    for si, f in enumerate(files):
        rows = []
        meta = []
        for _ in range(max_rows):
            line = f.readline()
            if not line:
                break
            v = line.rstrip("\n").split("\t")
            rows.append((int(v[4]), int(v[5]), int(v[6]), int(v[7])))
            if si == 0:
                meta.append((v[0], int(v[1]), v[2]))
        per_sample_counts.append(np.asarray(rows, dtype=np.int64).reshape(-1, 4))
        if si == 0:
            site_meta = meta
    n = len(site_meta)
    if n == 0:
        return None
    counts = np.stack([c[:n] for c in per_sample_counts], axis=0)
    return site_meta, counts


class _DirectChunks:
    """All sample files open at once — the fast path when the cohort
    fits the fd budget."""

    def __init__(self, sp: SpeciesGroup):
        self.files = _open_sample_files(sp)

    def read(self, max_rows: int):
        return _read_chunk(self.files, max_rows)

    def close(self):
        for f in self.files:
            f.close()


class _SpooledChunks:
    """fd-bounded two-phase streaming (the reference's RLIMIT_NOFILE
    sample batching, utility.py:38-57 + merge/snps.py:246-279): each
    contiguous sample batch is lock-step streamed with at most
    batch-size files open and spooled to ONE raw temp file of
    [n_rows, S_batch, 4] int32 records; the call phase then reads
    len(batches) spool files instead of len(samples) gz handles.

    Spool record layout: int64 n, int64 compressed_bytes, then a
    zlib(level 1) blob of n*S_b*4 int32 counts (sample-major). The
    counts are mostly zeros/small ints, so fast-level zlib typically
    shrinks the spool ~10x (a 5 Mb genome x 1,000 samples would be
    ~80 GB raw — the footprint is estimated up front and a warning
    printed when it is large even compressed). Site meta spools once,
    from batch 0's first file."""

    SPOOL_ROWS = 65536
    WARN_BYTES = 20 * 2**30

    def __init__(self, sp: SpeciesGroup, batches: List[List], tmpdir: str):
        import sys
        import zlib

        os.makedirs(tmpdir, exist_ok=True)
        self.tmpdir = tmpdir
        self.batch_sizes = [len(b) for b in batches]
        n_samples = sum(self.batch_sizes)
        try:
            glen = int(float(sp.samples[0].info[sp.id]["genome_length"]))
        except Exception:
            glen = 0
        raw_est = glen * n_samples * 16
        if raw_est:
            print(f"  spooling allele counts for {n_samples} samples x "
                  f"{glen} sites (~{raw_est / 2**30:.1f} GiB raw, "
                  "zlib-compressed on disk)", file=sys.stderr)
        self.bin_paths = []
        self.meta_path = os.path.join(tmpdir, "site_meta.txt")
        spooled = 0
        for bi, batch in enumerate(batches):
            files = _open_sample_files(sp, batch)
            path = os.path.join(tmpdir, f"counts.{bi}.bin")
            self.bin_paths.append(path)
            meta_f = open(self.meta_path, "w") if bi == 0 else None
            try:
                with open(path, "wb") as out:
                    while True:
                        chunk = _read_chunk(files, self.SPOOL_ROWS)
                        if chunk is None:
                            break
                        site_meta, counts = chunk  # counts [S_b, n, 4]
                        n = counts.shape[1]
                        blob = zlib.compress(
                            counts.transpose(1, 0, 2).astype(np.int32)
                            .tobytes(), 1)
                        np.asarray([n, len(blob)], dtype=np.int64).tofile(out)
                        out.write(blob)
                        spooled += len(blob) + 16
                        if spooled > self.WARN_BYTES:
                            print(f"Warning: SNP merge spool for {sp.id} "
                                  f"exceeds {spooled / 2**30:.0f} GiB on "
                                  "disk; consider --max_species or more "
                                  "open-file headroom (ulimit -n) to "
                                  "stream samples directly",
                                  file=sys.stderr)
                            spooled = -2**62  # warn once
                        if meta_f is not None:
                            for ref_id, ref_pos, ref_allele in site_meta:
                                meta_f.write(f"{ref_id}\t{ref_pos}\t{ref_allele}\n")
                        if n < self.SPOOL_ROWS:
                            break
            finally:
                if meta_f is not None:
                    meta_f.close()
                for f in files:
                    f.close()
        self._bins = [open(p, "rb") for p in self.bin_paths]
        self._meta = open(self.meta_path)
        # per-file remainder rows carried between read() calls
        self._pending = [np.zeros((0, sb, 4), np.int64) for sb in self.batch_sizes]

    def _pull_rows(self, bi: int, max_rows: int) -> np.ndarray:
        import zlib

        parts = [self._pending[bi]]
        have = parts[0].shape[0]
        sb = self.batch_sizes[bi]
        while have < max_rows:
            hdr = np.fromfile(self._bins[bi], dtype=np.int64, count=2)
            if hdr.size == 0:
                break
            n, nbytes = int(hdr[0]), int(hdr[1])
            rec = np.frombuffer(
                zlib.decompress(self._bins[bi].read(nbytes)), dtype=np.int32)
            parts.append(rec.reshape(n, sb, 4).astype(np.int64))
            have += n
        allrows = np.concatenate(parts, axis=0) if len(parts) > 1 else parts[0]
        self._pending[bi] = allrows[max_rows:]
        return allrows[:max_rows]

    def read(self, max_rows: int):
        meta = []
        for _ in range(max_rows):
            line = self._meta.readline()
            if not line:
                break
            ref_id, ref_pos, ref_allele = line.rstrip("\n").split("\t")
            meta.append((ref_id, int(ref_pos), ref_allele))
        if not meta:
            return None
        rows = len(meta)
        per_batch = [self._pull_rows(bi, rows) for bi in range(len(self._bins))]
        counts = np.concatenate(per_batch, axis=1).transpose(1, 0, 2)
        return meta, counts

    def close(self):
        for f in self._bins:
            f.close()
        self._meta.close()
        shutil.rmtree(self.tmpdir, ignore_errors=True)


def _make_chunk_source(sp: SpeciesGroup, args: Dict):
    from midas_tpu_torch.utils import batch_samples

    batches = batch_samples(sp.samples, threads=1)
    if len(batches) <= 1:
        return _DirectChunks(sp)
    tmpdir = os.path.join(args["outdir"], sp.id, "temp_spool")
    return _SpooledChunks(sp, batches, tmpdir)


class GeneSweep:
    """The reference's monotone gene-pointer annotation (snps.py:116-174),
    kept as an explicit cursor over (scaffold, start, -end)-sorted CDS
    genes; sites must arrive in ascending (ref_id, ref_pos) order."""

    def __init__(self, genes: List[dict]):
        self.genes = genes
        self.i = 0

    def annotate(self, ref_id: str, ref_pos: int) -> Dict[str, Optional[str]]:
        out = dict(locus_type=None, gene_id=None, site_type=None, amino_acids=None)
        while True:
            if self.i >= len(self.genes):
                out["locus_type"] = "IGR"
                return out
            gene = self.genes[self.i]
            if (ref_id < gene["scaffold_id"]
                    or (ref_id == gene["scaffold_id"] and ref_pos < gene["start"])):
                out["locus_type"] = "IGR"
                return out
            if (ref_id > gene["scaffold_id"]
                    or (ref_id == gene["scaffold_id"] and ref_pos > gene["end"])):
                self.i += 1
                continue
            # inside a CDS gene
            out["locus_type"] = gene.get("gene_type", "CDS")
            out["gene_id"] = gene["gene_id"]
            if out["locus_type"] != "CDS":
                return out
            if len(gene["seq"]) % 3 != 0:
                return out
            gene_pos = (ref_pos - gene["start"] if gene["strand"] == "+"
                        else gene["end"] - ref_pos)
            codon_pos = gene_pos % 3
            ref_codon = gene["seq"][gene_pos - codon_pos: gene_pos - codon_pos + 3]
            if not all(b in "ATCG" for b in ref_codon):
                return out
            aas = []
            for allele in ALLELES:
                codon = index_replace(ref_codon, allele, codon_pos, gene["strand"])
                aas.append(translate(codon))
            degeneracy = 4 - len(set(aas)) + 1
            out["site_type"] = f"{degeneracy}D"
            out["amino_acids"] = ",".join(aas)
            return out


def call_alleles_chunk(counts: np.ndarray, allele_freq: float):
    """Vectorized call_alleles over a chunk.

    counts [S, N, 4] -> dict with major/minor indexes (-1 = none),
    snp_type codes (0 none, 1 mono, 2 bi, 3 tri, 4 quad)."""
    pooled = counts.sum(axis=0)  # [N, 4]
    depth = pooled.sum(axis=1)   # [N]
    freqs = pooled / np.maximum(depth, 1)[:, None]
    # stable descending sort keeps A,C,G,T order on ties, matching the
    # reference's sorted(..., key=freq, reverse=True)
    order = np.argsort(-freqs, axis=1, kind="stable")  # [N, 4]
    f_sorted = np.take_along_axis(freqs, order, axis=1)
    has_depth = depth > 0
    major = np.where(has_depth & (f_sorted[:, 0] > 0), order[:, 0], -1)
    minor = np.where(has_depth & (f_sorted[:, 1] > 0), order[:, 1], -1)
    snp_type = np.zeros(len(depth), dtype=np.int8)
    for rank, code in ((0, 1), (1, 2), (2, 3), (3, 4)):  # mono..quad
        snp_type = np.where(
            has_depth & (f_sorted[:, rank] >= allele_freq), code, snp_type)
    return dict(pooled=pooled, depth=depth, major=major, minor=minor,
                snp_type=snp_type)


def per_sample_stats(counts: np.ndarray, major: np.ndarray, minor: np.ndarray):
    """Per-sample depths (major+minor) and minor-allele freqs [S, N]."""
    S, N, _ = counts.shape
    maj = np.clip(major, 0, 3)
    mnr = np.clip(minor, 0, 3)
    maj_counts = np.take_along_axis(counts, maj[None, :, None], axis=2)[:, :, 0]
    mnr_counts = np.take_along_axis(counts, mnr[None, :, None], axis=2)[:, :, 0]
    no_major = major < 0
    no_minor = minor < 0
    depths = np.where(no_major[None, :], 0,
                      np.where(no_minor[None, :], maj_counts,
                               maj_counts + mnr_counts))
    mafs = np.where(
        (~no_major[None, :]) & (~no_minor[None, :]) & (depths > 0),
        mnr_counts / np.maximum(depths, 1), 0.0)
    return depths, mafs


SNP_TYPE_NAMES = {0: None, 1: "mono", 2: "bi", 3: "tri", 4: "quad"}


def _na(x) -> str:
    return "NA" if x is None else str(x)


def merge_species_snps(sp: SpeciesGroup, args: Dict) -> int:
    """Merge one species across its samples; returns passing site count."""
    db = Database(args["db"])
    genes = GeneSweep(db.read_genes(sp.id))
    snp_types_wanted = args.get("snp_type", ["bi"])
    allele_freq = args.get("allele_freq", 0.01)
    site_depth_min = args.get("site_depth", 1)
    site_ratio = args.get("site_ratio", 2.0)
    site_prev = args.get("site_prev", 0.95)
    max_sites = args.get("max_sites", float("inf"))
    mean_depths = np.asarray(sp.sample_depth, dtype=np.float64)

    outdir = os.path.join(args["outdir"], sp.id)
    os.makedirs(outdir, exist_ok=True)
    info_f = open(os.path.join(outdir, "snps_info.txt"), "w")
    freq_f = open(os.path.join(outdir, "snps_freq.txt"), "w")
    depth_f = open(os.path.join(outdir, "snps_depth.txt"), "w")
    sample_ids = [s.id for s in sp.samples]
    for f in (freq_f, depth_f):
        f.write("\t".join(["site_id"] + sample_ids) + "\n")
    info_f.write("\t".join([
        "site_id", "ref_id", "ref_pos", "ref_allele", "major_allele",
        "minor_allele", "count_samples", "count_a", "count_c", "count_g",
        "count_t", "locus_type", "gene_id", "snp_type", "site_type",
        "amino_acids"]) + "\n")

    source = _make_chunk_source(sp, args)
    site_id = 0
    n_pass = 0
    try:
        while site_id < max_sites:
            chunk_rows = int(min(CHUNK_SITES, max_sites - site_id))
            chunk = source.read(chunk_rows)
            if chunk is None:
                break
            site_meta, counts = chunk
            called = call_alleles_chunk(counts, allele_freq)
            depths, mafs = per_sample_stats(counts, called["major"], called["minor"])
            pass_qc = (depths >= site_depth_min) & (
                depths / np.maximum(mean_depths[:, None], 1e-12) <= site_ratio)
            count_samples = pass_qc.sum(axis=0)
            prevalence = count_samples / max(len(sp.samples), 1)
            type_ok = np.isin(
                [SNP_TYPE_NAMES[t] for t in called["snp_type"]], snp_types_wanted
            ) if "any" not in snp_types_wanted else np.ones(len(site_meta), bool)
            passing = (prevalence >= site_prev) & type_ok
            for j in np.flatnonzero(passing):
                sid = site_id + j + 1
                ref_id, ref_pos, ref_allele = site_meta[j]
                ann = genes.annotate(ref_id, ref_pos)
                major = ALLELES[called["major"][j]] if called["major"][j] >= 0 else None
                minor = ALLELES[called["minor"][j]] if called["minor"][j] >= 0 else None
                pooled = called["pooled"][j]
                info_f.write("\t".join(_na(x) for x in [
                    sid, ref_id, ref_pos, ref_allele, major, minor,
                    count_samples[j], pooled[0], pooled[1], pooled[2], pooled[3],
                    ann["locus_type"], ann["gene_id"],
                    SNP_TYPE_NAMES[called["snp_type"][j]], ann["site_type"],
                    ann["amino_acids"]]) + "\n")
                freq_f.write(str(sid) + "\t" + "\t".join(
                    "{0:.3g}".format(m) for m in mafs[:, j]) + "\n")
                depth_f.write(str(sid) + "\t" + "\t".join(
                    str(int(d)) for d in depths[:, j]) + "\n")
                n_pass += 1
            site_id += len(site_meta)
            if len(site_meta) < chunk_rows:
                break
    finally:
        source.close()
        info_f.close()
        freq_f.close()
        depth_f.close()
    return n_pass


def run_pipeline(args: Dict) -> None:
    os.makedirs(args["outdir"], exist_ok=True)
    species_list = select_species(args, dtype="snps")
    for sp in species_list:
        merge_species_snps(sp, args)
        sp.write_sample_info(dtype="snps", outdir=args["outdir"])
        _write_readme(args, sp)


def _write_readme(args: Dict, sp: SpeciesGroup) -> None:
    with open(os.path.join(args["outdir"], sp.id, "readme.txt"), "w") as f:
        f.write(f"""
Description of output files and file formats from 'merge_midas.py snps'

Output files
############
snps_freq.txt
  frequency of minor allele per genomic site and per sample
  a value of 1.0 indicates that all reads matched the minor allele for site-sample
  the major (most common) and minor allele (2nd most common) are determined from pooled reads across ALL samples
  see: snps_info.txt for details on the major, minor, and reference alleles
snps_depth.txt
  number of reads mapped to genomic site per sample
  only accounts for reads matching either major or minor allele
snps_info.txt
  metadata for genomic site
snps_summary.txt
  alignment summary statistics per sample
snps_log.txt
  log file containing parameters used

Output formats
############
snps_freq.txt and snps_depth.txt
  tab-delimited matrix files
  field names are sample ids
  row names are genome site ids
snps_info.txt
  site_id: incrementing integer field
  ref_id: identifier of scaffold in representative genome
  ref_pos: position of site on ref_id
  ref_allele: allele in reference genome
  major_allele: most common allele in metagenomes
  minor_allele: second most common allele in metagenomes
  count_samples: number of metagenomes where site_id was found
  count_a: count of A allele in pooled metagenomes
  count_c: count of C allele in pooled metagenomes
  count_g: count of G allele in pooled metagenomes
  count_t: count of T allele in pooled metagenomes
  locus_type: CDS (site in coding gene), RNA (site in non-coding gene), IGR (site in intergenic region)
  gene_id: gene identified if locus_type is CDS, or RNA
  snp_type: indicates the number of alleles observed at site (mono,bi,tri,quad); observed allele are determined by --snp_maf flag
  site_type: indicates degeneracy: 1D, 2D, 3D, 4D
  amino_acids: amino acids encoded by 4 possible alleles

Additional information for species can be found in the reference database:
 {args['db']}/rep_genomes/{sp.id}
""")
