"""Pangenome CNV profiling — midas/run/genes.py on PyTorch.

Reads are aligned with the quality-scaled local (or, with -m global,
end-to-end) aligner against a per-run pack of the selected species'
99%-identity gene centroids (replacing build_pangenome_db + bowtie2
--very-sensitive-local at genes.py:84-145). Gene depths are per-gene
aligned-bp sums over kept reads (count_mapped_bp :171-203), copy numbers
normalize by the median depth of the species' 15 marker genes
(normalize :205-218), and outputs are per-species
<outdir>/genes/output/<sp>.genes.gz plus genes/summary.txt
(write_results :220-245).

Reads are single-end, or mate pairs (-1/-2, --interleaved) whose best
concordant pair fixes both mates' hits (device_steps.
paired_best_hit_device). Outputs equal midas_tpu's single-device path
byte for byte (after decompression). Under a launch of several
processes, run_genes routes to the data-parallel driver
(dist/driver.py), one rank per card.
"""

from __future__ import annotations

import os
import sys
from typing import Dict, List, Optional

import numpy as np
import torch

from midas_tpu_torch import tracing
from midas_tpu_torch.align.params import GLOBAL_SCORING, LOCAL_SCORING
from midas_tpu_torch.align.pipeline import Aligner, resolve_device
from midas_tpu_torch.align.seed import SeedParams
from midas_tpu_torch.db.index import build_seed_index
from midas_tpu_torch.db.layout import Database
from midas_tpu_torch.db.refpack import pack_from_fasta
from midas_tpu_torch.dist import driver
from midas_tpu_torch.io.seqio import iopen, parse_file
from midas_tpu_torch.profile import common
from midas_tpu_torch.profile.common import (_multi_process,
                                            resolve_species_list,
                                            select_batches)


class GenesProfiler:
    """Two-pass aligner + per-gene accumulators bound to one run's
    pangenome pack, its tensors on one device (the card unless
    device="cpu")."""

    def __init__(
        self,
        db: Database,
        species_ids: List[str],
        mapid: float = 94.0,
        readq: float = 20.0,
        mapq: int = 0,
        aln_cov: float = 0.75,
        seed_params: Optional[SeedParams] = None,
        max_read_len: int = 128,
        mode: str = "local",
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.db = db
        self.species_ids = list(species_ids)
        self.mapid, self.readq, self.mapq, self.aln_cov = mapid, readq, mapq, aln_cov
        # the reference's -m local/global flag picks the bowtie2
        # personality (local default for pangenome CNV mapping,
        # midas/run/genes.py:116-145)
        self.mode = mode
        # per-run pangenome pack over selected species (genes.py:84-114)
        self.pack = pack_from_fasta([db.pangenome_fasta(s) for s in self.species_ids])
        sp_index = {s: i for i, s in enumerate(self.species_ids)}
        # gene -> species from per-species fasta ordering
        self.gene_species = np.zeros(self.pack.num_seqs, dtype=np.int32)
        cursor = 0
        for s in self.species_ids:
            n = sum(1 for _ in _fasta_ids(db.pangenome_fasta(s)))
            self.gene_species[cursor: cursor + n] = sp_index[s]
            cursor += n
        if cursor != self.pack.num_seqs:
            raise ValueError(f"pangenome fastas hold {cursor} genes, the "
                             f"pack {self.pack.num_seqs}")
        # marker ids per gene (genes.py:74-82): only genes present in the
        # pangenome pack get a marker annotation
        name_to_idx = {n: i for i, n in enumerate(self.pack.names)}
        self.gene_marker = np.full(self.pack.num_seqs, -1, dtype=np.int32)
        marker_ids = sorted(db.marker_cutoffs())
        marker_index = {m: i for i, m in enumerate(marker_ids)}
        for r in parse_file(_marker_map_path(db)):
            gi = name_to_idx.get(r["gene_id"])
            if gi is not None:
                self.gene_marker[gi] = marker_index[r["marker_id"]]
        self.n_markers = len(marker_ids)
        sp = seed_params or SeedParams(num_cands=4)
        scoring = LOCAL_SCORING if mode == "local" else GLOBAL_SCORING
        self.aligner = self._make_aligner(scoring, sp, max_read_len)

    def _make_aligner(self, scoring, seed_params, max_read_len):
        """The aligner over the profiler's pack on its device
        (dist/profilers.py's subclass shards it instead)."""
        self.index = build_seed_index(self.pack, k=seed_params.k)
        return Aligner(self.pack, self.index, scoring, seed_params,
                       max_read_len=max_read_len, device=self.device)

    def run(self, read_paths, max_reads=None, trim=0, batch_size: int = 8192,
            checkpoint_path=None, align_only: bool = False,
            paired: bool = False, interleaved: bool = False,
            read_length=None) -> Optional[Dict]:
        """Device-resident CNV counting: per-gene accumulators live on
        the device (profile.device_steps.genes_update, updated in place
        every batch) and come back once at the end — no per-batch
        readback. Batches parse and upload in a background thread; with
        checkpoint_path the state persists periodically (crash recovery
        and the reference's --align / --call_genes stage split). With
        paired, read_paths is [m1, m2], or [m1] with interleaved. Traced
        as the span profile.sample, the root of the run's spans."""
        with tracing.span(tracing.SAMPLE, path="genes"):
            host = self._accumulate(read_paths, max_reads, trim, batch_size,
                                    checkpoint_path, paired=paired,
                                    interleaved=interleaved,
                                    read_length=read_length)
            if align_only:
                return None
            return self._finalize(host)

    def _accumulate(self, read_paths, max_reads, trim, batch_size,
                    checkpoint_path=None, checkpoint_every: int = 64,
                    paired: bool = False, interleaved: bool = False,
                    read_length=None):
        from midas_tpu_torch.io.prefetch import prefetch_device_batches
        from midas_tpu_torch.profile import checkpoint as ckpt
        from midas_tpu_torch.profile import device_steps as ds

        G = self.pack.num_seqs
        al = self.aligner
        dev = self.device
        state = ds.genes_init(G, dev)
        smin_table = torch.from_numpy(
            ds.score_min_table(al.scoring, al.max_read_len)).to(dev)
        skip = 0
        fp = None
        if checkpoint_path:
            fp = self._fingerprint(read_paths, max_reads, trim, batch_size,
                                   paired=paired, interleaved=interleaved,
                                   read_length=read_length)
            got = ckpt.load(checkpoint_path, fp)
            if got is not None:
                arrays, meta = got
                state = ds.genes_state_restore(arrays, dev)
                skip = int(meta["batches_done"])
        last_index = skip - 1
        batches = select_batches(read_paths, batch_size, al.max_read_len,
                                 max_reads, paired, interleaved,
                                 read_length=read_length)
        if getattr(self, "_batch_filter", None):
            batches = self._batch_filter(batches)  # multi-process striding
        for db in prefetch_device_batches(
                batches, ("codes", "quals", "lengths", "mean_qual"),
                device=dev, skip_batches=skip, trim=trim):
            last_index = db.index
            codes, quals, lengths, mean_qual = db.arrays
            with tracing.span("profile.step", batch=db.index,
                              reads=db.n_reads):
                self._genes_step(state, codes, quals, lengths, mean_qual,
                                 db.n_reads, smin_table, bool(paired))
            if checkpoint_path and (db.index + 1) % checkpoint_every == 0:
                ckpt.save(checkpoint_path, ds.genes_state_host(state),
                          dict(fingerprint=fp, batches_done=db.index + 1,
                               guard=self._guard()))
        host = ds.genes_state_host(state)
        if checkpoint_path:
            ckpt.save(checkpoint_path, host,
                      dict(fingerprint=fp, batches_done=last_index + 1,
                           guard=self._guard()))
        return host

    def _genes_step(self, state, codes, quals, lengths, mean_qual, n_reads,
                    smin_table, paired: bool) -> None:
        """One batch of CNV counting, state updated in place."""
        from midas_tpu_torch.profile import device_steps as ds

        al = self.aligner
        ds.genes_update(
            state, al.index_arrays, al.pack_arrays, self.pack.num_seqs,
            codes, quals, lengths, mean_qual, n_reads, scoring=al.scoring,
            seed_params=al.seed_params, max_len=al.max_read_len,
            mapid=float(self.mapid), readq=float(self.readq),
            min_mapq=int(self.mapq), aln_cov=float(self.aln_cov),
            smin_table=smin_table, paired=paired)

    def _guard(self) -> Dict:
        """Finalize-relevant parameters persisted in checkpoint meta:
        a later --call_genes stage verifies these instead of the stream
        fingerprint (checkpoint.load_guarded)."""
        return dict(kind="genes", mapid=self.mapid, readq=self.readq,
                    mapq=self.mapq, aln_cov=self.aln_cov, mode=self.mode,
                    species=list(self.species_ids),
                    num_seqs=int(self.pack.num_seqs))

    def _fingerprint(self, read_paths, max_reads, trim, batch_size,
                     paired=False, interleaved=False,
                     read_length=None) -> str:
        from midas_tpu_torch.profile import checkpoint as ckpt

        return ckpt.fingerprint(
            kind="genes", schema=2,  # 2: quality-scaled --mp/--np scoring
            paths=list(map(str, np.atleast_1d(read_paths))),
            max_reads=max_reads, trim=trim, batch_size=batch_size,
            mapid=self.mapid, readq=self.readq, mapq=self.mapq,
            aln_cov=self.aln_cov, species=self.species_ids,
            paired=paired, interleaved=interleaved,
            read_length=read_length)

    def finalize_from_checkpoint(self, checkpoint_path,
                                 force: bool = False) -> Dict:
        """--call_genes without --align: consume the persisted aligned
        state (the reference's equivalent reads temp/pangenomes.bam,
        scripts/run_midas.py:535-566), erroring when it was written
        under different filter params / species / pack geometry."""
        from midas_tpu_torch.profile import checkpoint as ckpt

        got = ckpt.load_guarded(checkpoint_path, self._guard(), force=force)
        if got is None:
            sys.exit(f"\nError: no usable alignment state at {checkpoint_path}\n"
                     "Run with --align first\n")
        return self._finalize(got[0])

    @tracing.traced("profile.finalize")
    def _finalize(self, host: Dict) -> Dict:
        G = self.pack.num_seqs
        aligned_reads = np.asarray(host["aligned_reads"][:G]).astype(np.int64)
        mapped_reads = np.asarray(host["mapped_reads"][:G]).astype(np.int64)
        gene_len = self.pack.lengths.astype(np.float64)
        depth = np.asarray(host["bp"][:G]).astype(np.float64) / np.maximum(gene_len, 1.0)

        # normalize by median marker depth (genes.py:205-218)
        S = len(self.species_ids)
        marker_cov = np.zeros(S, dtype=np.float64)
        for si in range(S):
            vals = []
            for mi in range(self.n_markers):
                sel = (self.gene_species == si) & (self.gene_marker == mi)
                if sel.any():
                    vals.append(depth[sel].sum())
            marker_cov[si] = float(np.median(vals)) if vals else 0.0
        copies = np.zeros(G, dtype=np.float64)
        for si in range(S):
            if marker_cov[si] > 0:
                sel = self.gene_species == si
                copies[sel] = depth[sel] / marker_cov[si]

        self.results = dict(
            aligned_reads=aligned_reads, mapped_reads=mapped_reads,
            depth=depth, copies=copies, marker_cov=marker_cov,
        )
        return self.results

    @tracing.traced("write.results", path="genes")
    def write_results(self, outdir: str) -> None:
        """Per-species .genes.gz + genes/summary.txt (genes.py:220-245)."""
        r = self.results
        os.makedirs(os.path.join(outdir, "genes/output"), exist_ok=True)
        order = np.argsort(np.asarray(self.pack.names))  # sorted gene ids
        handles = {}
        for si, sid in enumerate(self.species_ids):
            path = os.path.join(outdir, f"genes/output/{sid}.genes.gz")
            handles[si] = iopen(path, "wt")
            handles[si].write("\t".join(
                ["gene_id", "count_reads", "coverage", "copy_number"]) + "\n")
        for gi in order:
            si = self.gene_species[gi]
            handles[si].write("\t".join(str(x) for x in [
                self.pack.names[gi], r["mapped_reads"][gi],
                r["depth"][gi], r["copies"][gi]]) + "\n")
        for h in handles.values():
            h.close()
        with open(os.path.join(outdir, "genes/summary.txt"), "w") as f:
            f.write("\t".join([
                "species_id", "pangenome_size", "covered_genes",
                "fraction_covered", "mean_coverage", "marker_coverage",
                "aligned_reads", "mapped_reads"]) + "\n")
            for si, sid in enumerate(self.species_ids):
                sel = self.gene_species == si
                d = r["depth"][sel]
                nz = d[d > 0]
                pangenome_size = int(sel.sum())
                covered = len(nz)
                mean_cov = float(nz.mean()) if covered else 0
                f.write("\t".join(str(x) for x in [
                    sid, pangenome_size, covered,
                    covered / float(pangenome_size) if pangenome_size else 0,
                    mean_cov, r["marker_cov"][si],
                    int(r["aligned_reads"][sel].sum()),
                    int(r["mapped_reads"][sel].sum())]) + "\n")


def _fasta_ids(path):
    from midas_tpu_torch.io.seqio import read_fastx
    with iopen(path) as fp:
        for name, _s, _q in read_fastx(fp):
            yield name


def _marker_map_path(db: Database):
    for ext in ["", ".gz"]:
        p = os.path.join(db.dir, "marker_genes/phyeco.map" + ext)
        if os.path.isfile(p):
            return p
    raise FileNotFoundError("phyeco.map")


def run_genes(args: Dict) -> Optional[GenesProfiler]:
    """The genes pipeline end to end, with the reference output layout
    and per-stage timing/memory prints (genes.py:252-291). args["device"]
    picks the device (default "cuda"); batches hold common.BATCH_SIZE
    reads. Reads single-end (-1), mate pairs (-1/-2) or
    interleaved mate pairs (-1 with --interleaved).

    Under a launch of several processes it routes to the multi-process
    driver (dist/driver.py), which always runs the full pipeline: stage
    splits exit there, as in midas_tpu; rank 0 writes the outputs and
    species.txt, and returns None."""
    from midas_tpu_torch.io.batch import detect_max_read_len
    from midas_tpu_torch.utils import stage_timer

    multi = _multi_process()
    if multi:
        driver.initialize()
    device = resolve_device(args.get("device") or "cuda")
    batch_size = common.BATCH_SIZE
    outdir = args["outdir"]
    log = args.get("log")
    os.makedirs(os.path.join(outdir, "genes/temp"), exist_ok=True)
    os.makedirs(os.path.join(outdir, "genes/output"), exist_ok=True)
    db = Database(args["db"])
    species_ids = resolve_species_list(args, db, "genes")
    if not species_ids:
        # reference behavior: exit cleanly when no species pass the
        # abundance filters (midas/run/species.py:191-227 returns an
        # empty selection; downstream stages then have nothing to do)
        sys.exit("\nError: no species satisfied your selection criteria.\n"
                 "Try running with more lenient parameters "
                 "(e.g. --species_cov, --species_topn, or --species_id)")
    # stage gating: --build_db alone only persists the species list (the
    # reference's later stages need its BAM intermediates; ours need
    # the temp/state.npz alignment-state checkpoint)
    if args.get("build_db") and not (args.get("align") or args.get("cov")):
        return None

    state_path = os.path.join(outdir, "genes/temp/state.npz")
    scan_paths = [p for p in (args.get("m1"), args.get("m2")) if p]
    max_read_len = (detect_max_read_len(scan_paths, args.get("read_length"))
                    if scan_paths else 128)
    paired = bool(args.get("m2")) or bool(args.get("interleaved"))
    if multi:
        # the driver always runs the FULL align+cov pipeline; stage
        # splits and checkpoints are single-process features, and
        # partial invocations exit rather than do more (or less) than
        # asked
        if not (args.get("build_db") and args.get("align")
                and args.get("cov")):
            sys.exit("\nError: multi-host genes runs the full pipeline; "
                     "--build_db/--align/--call_genes stage splits are "
                     "single-host features\n")
        with stage_timer("Profiling pangenomes over "
                         f"{driver.process_count()} ranks", log):
            driver.run_genes_multihost(
                db, scan_paths, species_ids, outdir=outdir,
                batch_size=batch_size, max_reads=args.get("max_reads"),
                trim=args.get("trim", 0), paired=paired,
                interleaved=bool(args.get("interleaved")),
                read_length=args.get("read_length"),
                mapid=args.get("mapid", 94.0), readq=args.get("readq", 20.0),
                mapq=args.get("mapq", 0), aln_cov=args.get("aln_cov", 0.75),
                mode=args.get("mode", "local"), max_read_len=max_read_len,
                device=device)
        if args.get("remove_temp") and driver.process_index() == 0:
            import shutil
            shutil.rmtree(os.path.join(outdir, "genes/temp"),
                          ignore_errors=True)
        return None

    with stage_timer("Building pangenome database", log):
        profiler = GenesProfiler(
            db, species_ids,
            mapid=args.get("mapid", 94.0), readq=args.get("readq", 20.0),
            mapq=args.get("mapq", 0), aln_cov=args.get("aln_cov", 0.75),
            mode=args.get("mode", "local"), max_read_len=max_read_len,
            device=device,
        )
    if args.get("align") or args.get("build_db"):
        paths = [args["m1"]]
        if args.get("m2"):
            paths.append(args["m2"])
        with stage_timer("Aligning reads to pangenomes", log):
            profiler.run(paths, max_reads=args.get("max_reads"),
                         trim=args.get("trim", 0), batch_size=batch_size,
                         paired=paired,
                         interleaved=bool(args.get("interleaved")),
                         read_length=args.get("read_length"),
                         checkpoint_path=state_path,
                         align_only=not args.get("cov"))
        if not args.get("cov"):
            return profiler
        with stage_timer("Computing coverage of pangenomes", log):
            profiler.write_results(outdir)
    elif args.get("cov"):
        with stage_timer("Computing coverage of pangenomes", log):
            profiler.finalize_from_checkpoint(state_path, force=bool(args.get("force")))
            profiler.write_results(outdir)
    if args.get("remove_temp"):
        import shutil
        shutil.rmtree(os.path.join(outdir, "genes/temp"))
    return profiler
