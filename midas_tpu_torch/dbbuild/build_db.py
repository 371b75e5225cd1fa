"""Custom reference-database construction — build_midas_db in host
numpy (reference: midas/build/build_db.py + the
scripts/build_midas_db.py CLI). It touches no device.

Pipeline parity (run_pipeline, build_db.py:481-501):
1. parse the mapfile (genome_id, species_id, rep_genome)
2. species_info.txt / genome_info.txt
3. per-species pangenome: genes < 20kb pooled, clustered at
   99/95/90/85/80/75% identity (native greedy k-mer clustering in
   cluster.py replaces vsearch), centroids.ffn + gene_info.txt
4. representative genomes: genome.fna copied; genome.features built by
   locating each gene on its contig (find_gene, build_db.py:273-284)
5. marker genes: each rep genome's proteins searched against the 15
   PhyEco profile HMMs (native Viterbi in hmm.py replaces hmmsearch);
   best hit per family at e <= 1e-5 -> phyeco.fa / phyeco.map, plus
   phyeco.mapping_cutoffs with the published per-family thresholds

Expected input layout per genome (same as the reference's):
    <indir>/<genome_id>/<genome_id>.fna   contigs
    <indir>/<genome_id>/<genome_id>.ffn   gene nucleotide seqs
    <indir>/<genome_id>/<genome_id>.faa   gene protein seqs (markers)
"""

from __future__ import annotations

import os
import shutil
import sys
from typing import Dict, List, Optional

from midas_tpu_torch.db.layout import DEFAULT_MARKER_CUTOFFS
from midas_tpu_torch.dbbuild.cluster import cluster_levels
from midas_tpu_torch.io.seqio import iopen, read_fastx
from midas_tpu_torch.utils import rev_comp

MAX_GENE_LENGTH = 20_000  # build_db.py store_genes max_length


def parse_mapping_file(path: str) -> List[dict]:
    """Mapfile rows (parse_mapping_file, build_db.py:215-232)."""
    with iopen(path) as f:
        fields = f.readline().rstrip("\n").split("\t")
        for field in ["genome_id", "species_id"]:
            if field not in fields:
                sys.exit(f"Error: mapping file '{path}' has no field labeled '{field}'")
        for field in fields:
            if field not in ["genome_id", "species_id", "rep_genome"]:
                sys.exit(f"Error: mapping file '{path}' has unknown field labeled '{field}'")
        rows = []
        for line in f:
            if not line.strip():
                continue
            values = line.rstrip("\n").split("\t")
            if len(values) < len(fields):
                sys.exit(f"Error: mapping file '{path}' has different number of fields per row")
            rows.append(dict(zip(fields, values)))
    return rows


def _read_fasta(path: str) -> Dict[str, str]:
    out = {}
    with iopen(path) as fp:
        for name, seq, _q in read_fastx(fp):
            out[name] = seq.upper()
    return out


def find_gene(gene_seq: str, contigs: List[List[str]]):
    """Locate a gene on its genome (find_gene, build_db.py:273-284):
    exact substring search on both strands; 1-based inclusive coords."""
    fwd = gene_seq.upper()
    rev = rev_comp(fwd)
    for cid, contig in contigs:
        for seq, strand in [(fwd, "+"), (rev, "-")]:
            start = contig.find(seq)
            if start >= 0:
                return cid, start + 1, start + len(seq), strand
    return None


def run_build(args: Dict) -> None:
    outdir = args["outdir"]
    os.makedirs(outdir, exist_ok=True)
    rows = parse_mapping_file(args["mapfile"])

    # group genomes by species; pick rep. --max_genomes caps mapfile-order
    # genomes per species, like the reference (read_species,
    # build_db.py:234-258: genomes past the cap are dropped but the rep
    # flag of a kept genome still wins)
    max_genomes = args.get("max_genomes") or float("inf")
    species: Dict[str, dict] = {}
    for r in rows:
        sp = species.setdefault(r["species_id"], dict(genomes=[], rep=None))
        if len(sp["genomes"]) < max_genomes:
            sp["genomes"].append(r["genome_id"])
            if r.get("rep_genome") == "1" or sp["rep"] is None:
                sp["rep"] = r["genome_id"]
    if args.get("max_species"):
        keep = list(species)[: args["max_species"]]
        species = {k: species[k] for k in keep}
    resume = bool(args.get("resume"))

    def _done(*paths) -> bool:
        """--resume: skip a step whose outputs already exist non-empty
        (the reference's checks at build_db.py:120-143, 316-318, 367)."""
        return resume and all(
            os.path.exists(p) and os.stat(p).st_size > 0 for p in paths)

    indir = args["indir"]

    def gpath(gid, ext):
        return os.path.join(indir, gid, f"{gid}.{ext}")

    # 1-2. info tables (write_species_info/write_genome_info :330-346)
    with open(os.path.join(outdir, "species_info.txt"), "w") as f:
        f.write("species_id\trep_genome\tcount_genomes\n")
        for sid, sp in species.items():
            f.write(f"{sid}\t{sp['rep']}\t{len(sp['genomes'])}\n")
    with open(os.path.join(outdir, "genome_info.txt"), "w") as f:
        f.write("genome_id\tspecies_id\trep_genome\n")
        for sid, sp in species.items():
            for gid in sp["genomes"]:
                f.write(f"{gid}\t{sid}\t{'1' if gid == sp['rep'] else '0'}\n")

    # 3. pangenomes
    levels = (99, 95, 90, 85, 80, 75)
    for sid, sp in species.items():
        pdir = os.path.join(outdir, "pan_genomes", sid)
        os.makedirs(pdir, exist_ok=True)
        if _done(os.path.join(pdir, "centroids.ffn"),
                 os.path.join(pdir, "gene_info.txt")):
            continue
        names, seqs, genome_of = [], [], {}
        for gid in sp["genomes"]:
            for name, seq in _read_fasta(gpath(gid, "ffn")).items():
                if not seq or len(seq) >= MAX_GENE_LENGTH:
                    continue
                names.append(name)
                seqs.append(seq)
                genome_of[name] = gid
        maps = cluster_levels(names, seqs, levels=levels,
                              k=args.get("cluster_k", 12))
        centroids = sorted(set(maps[99].values()), key=names.index)
        seq_by_name = dict(zip(names, seqs))
        with open(os.path.join(pdir, "centroids.ffn"), "w") as f:
            for c in centroids:
                f.write(f">{c}\n{seq_by_name[c]}\n")
        with open(os.path.join(pdir, "genes.ffn"), "w") as f:
            for n in names:
                f.write(f">{n}\n{seq_by_name[n]}\n")
        with open(os.path.join(pdir, "gene_info.txt"), "w") as f:
            cols = (["gene_id", "genome_id", "gene_length"]
                    + [f"centroid_{p}" for p in levels])
            f.write("\t".join(cols) + "\n")
            for n in sorted(names):
                row = [n, genome_of[n], str(len(seq_by_name[n]))]
                row += [maps[p][n] for p in levels]
                f.write("\t".join(row) + "\n")

    # 4. rep genomes + features
    for sid, sp in species.items():
        rdir = os.path.join(outdir, "rep_genomes", sid)
        os.makedirs(rdir, exist_ok=True)
        if _done(os.path.join(rdir, "genome.fna"),
                 os.path.join(rdir, "genome.features")):
            continue
        rep = sp["rep"]
        shutil.copy(gpath(rep, "fna"), os.path.join(rdir, "genome.fna"))
        contigs = [[cid, seq] for cid, seq in _read_fasta(gpath(rep, "fna")).items()]
        with open(os.path.join(rdir, "genome.features"), "w") as f:
            f.write("gene_id\tscaffold_id\tstart\tend\tstrand\tgene_type\n")
            for name, seq in _read_fasta(gpath(rep, "ffn")).items():
                loc = find_gene(seq, contigs)
                if loc is None:
                    continue
                cid, start, end, strand = loc
                f.write(f"{name}\t{cid}\t{start}\t{end}\t{strand}\tCDS\n")

    # 5. marker genes
    mdir = os.path.join(outdir, "marker_genes")
    os.makedirs(mdir, exist_ok=True)
    if _done(os.path.join(mdir, "phyeco.fa"), os.path.join(mdir, "phyeco.map"),
             os.path.join(mdir, "phyeco.mapping_cutoffs")):
        _install_kegg(outdir)
        if args.get("compress"):
            _compress(outdir)
        return
    hmm_path = args.get("hmms")
    marker_rows = []
    marker_seqs = {}
    if hmm_path:
        from midas_tpu_torch.dbbuild.hmm import parse_hmm_file, search_proteins
        models = parse_hmm_file(hmm_path)
        for sid, sp in species.items():
            for gid in sp["genomes"]:
                faa = gpath(gid, "faa")
                if not os.path.isfile(faa):
                    continue
                proteins = _read_fasta(faa)
                fna = _read_fasta(gpath(gid, "ffn"))
                hits = search_proteins(models, proteins,
                                       max_evalue=args.get("max_evalue", 1e-5))
                for family, (pid_, _bits, _ev) in hits.items():
                    gene = fna.get(pid_)
                    if gene is None:
                        continue
                    marker_rows.append((sid, gid, pid_, len(gene), family))
                    if gid == sp["rep"]:
                        marker_seqs[pid_] = gene
    elif args.get("marker_map"):
        # homology-free mode: an explicit gene_id -> marker_id table
        # (used by tests and by DB ports where families are already known)
        for line in open(args["marker_map"]):
            gid_gene, family = line.split()
            gid = gid_gene.rsplit(".", 2)[0] if "." in gid_gene else gid_gene
            for sid, sp in species.items():
                for g in sp["genomes"]:
                    fna = _read_fasta(gpath(g, "ffn"))
                    if gid_gene in fna:
                        marker_rows.append((sid, g, gid_gene, len(fna[gid_gene]), family))
                        if g == sp["rep"]:
                            marker_seqs[gid_gene] = fna[gid_gene]
    with open(os.path.join(mdir, "phyeco.fa"), "w") as fa:
        for gene_id, seq in marker_seqs.items():
            fa.write(f">{gene_id}\n{seq}\n")
    with open(os.path.join(mdir, "phyeco.map"), "w") as mp:
        mp.write("species_id\tgenome_id\tgene_id\tgene_length\tmarker_id\n")
        for row in marker_rows:
            mp.write("\t".join(str(x) for x in row) + "\n")
    with open(os.path.join(mdir, "phyeco.mapping_cutoffs"), "w") as f:
        for marker_id, cutoff in DEFAULT_MARKER_CUTOFFS.items():
            f.write(f"{marker_id}\t{cutoff}\n")

    _install_kegg(outdir)
    if args.get("compress"):
        _compress(outdir)


def _install_kegg(outdir: str) -> None:
    """Ship the packaged KEGG cpd_to_enzyme table into the DB so
    query_by_compound works out of the box (the reference embeds the
    table in the script itself, query_by_compound.py:9-27823)."""
    from midas_tpu_torch.analyze.query_compound import packaged_cpd_to_enzyme

    src = packaged_cpd_to_enzyme()
    if src is None:
        return
    kdir = os.path.join(outdir, "kegg")
    os.makedirs(kdir, exist_ok=True)
    dst = os.path.join(kdir, "cpd_to_enzyme.txt.gz")
    if not os.path.exists(dst):
        shutil.copy(src, dst)


def _compress(outdir: str) -> None:
    """Gzip pangenome/rep-genome files in place (build_db.py:348-359)."""
    import gzip

    for module in ["pan_genomes", "rep_genomes"]:
        mdir = os.path.join(outdir, module)
        if not os.path.isdir(mdir):
            continue
        for sp in os.listdir(mdir):
            spdir = os.path.join(mdir, sp)
            for fn in os.listdir(spdir):
                path = os.path.join(spdir, fn)
                if path.endswith(".gz"):
                    continue
                with open(path, "rb") as src, gzip.open(path + ".gz", "wb") as dst:
                    shutil.copyfileobj(src, dst)
                os.remove(path)
