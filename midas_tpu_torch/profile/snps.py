"""SNP pileup profiling — midas/run/snps.py on PyTorch.

Reads are aligned end to end (glocal; with -m local, locally) against a
per-run pack of the selected species' representative genomes (replacing
build_genome_db + bowtie2 + samtools sort at snps.py:69-128). The pysam
count_coverage pileup (:164-216) becomes an integer scatter-add of base
counts on the device: each kept read adds its bases at the reference
positions of its alignment, masked by base quality >= baseq. Gapless
reads, nearly all of them, have a closed-form column map; gapped reads
are spilled and get the exact traceback of the host oracle
(align/oracle.py) after the stream, under the same quality-scaled
scoring the device DP used.

Output contract: per-species <outdir>/snps/output/<sp>.snps.gz with one
row per genomic position (ref_id, ref_pos 1-based, ref_allele, depth,
count_a, count_c, count_g, count_t) over contigs in sorted id order,
plus snps/summary.txt (snps_summary :247-262).

Outputs equal midas_tpu's single-device path byte for byte (after
decompression) wherever the two gapped-read oracles agree: midas_tpu's
batched oracle scores every mismatch with the flat penalty, this one
with the per-base quality penalty, as the device DP does
(align/oracle.py). Reads are single-end or mate pairs (-1/-2,
--interleaved); pairing changes only which candidate each read takes.
Under a launch of several processes, run_snps routes to the
data-parallel driver (dist/driver.py), one rank per card.
"""

from __future__ import annotations

import os
import sys
from typing import Dict, List, Optional

import numpy as np
import torch

from midas_tpu_torch import tracing
from midas_tpu_torch.align.oracle import align_oracle_batch
from midas_tpu_torch.align.params import GLOBAL_SCORING, LOCAL_SCORING
from midas_tpu_torch.align.pipeline import Aligner, resolve_device
from midas_tpu_torch.align.seed import SeedParams
from midas_tpu_torch.db.index import build_seed_index
from midas_tpu_torch.db.layout import Database
from midas_tpu_torch.db.refpack import pack_from_fasta
from midas_tpu_torch.dist import driver
from midas_tpu_torch.io.native import load_native, write_sites_gz
from midas_tpu_torch.io.seqio import CODE_TO_BASE, iopen
from midas_tpu_torch.profile import common
from midas_tpu_torch.profile.common import (_multi_process,
                                            resolve_species_list,
                                            select_batches)

GAP_CAP = 131072   # gapped-read staging rows between drains


class SnpsProfiler:
    """Two-pass aligner + device pileup bound to one run's pack of
    representative genomes, its tensors on one device (the card unless
    device="cpu")."""

    def __init__(
        self,
        db: Database,
        species_ids: List[str],
        mapid: float = 94.0,
        readq: float = 20.0,
        mapq: int = 20,
        baseq: int = 30,
        aln_cov: float = 0.75,
        seed_params: Optional[SeedParams] = None,
        max_read_len: int = 128,
        mode: str = "global",
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.db = db
        self.species_ids = list(species_ids)
        self.mapid, self.readq, self.mapq = mapid, readq, mapq
        # the reference's -m global/local flag (global default for
        # rep-genome SNP mapping, midas/run/snps.py:97-128)
        self.mode = mode
        self.baseq, self.aln_cov = baseq, aln_cov
        self.pack = pack_from_fasta([db.rep_genome_fasta(s)
                                     for s in self.species_ids])
        # contig -> species from per-file contig counts
        self.contig_species = np.zeros(self.pack.num_seqs, dtype=np.int32)
        cursor = 0
        for si, s in enumerate(self.species_ids):
            n = _count_fasta_records(db.rep_genome_fasta(s))
            self.contig_species[cursor: cursor + n] = si
            cursor += n
        if cursor != self.pack.num_seqs:
            raise ValueError(f"genome fastas hold {cursor} contigs, the "
                             f"pack {self.pack.num_seqs}")
        sp = seed_params or SeedParams(num_cands=4)
        scoring = GLOBAL_SCORING if mode == "global" else LOCAL_SCORING
        self.aligner = self._make_aligner(scoring, sp, max_read_len)

    def _make_aligner(self, scoring, seed_params, max_read_len):
        """The aligner over the profiler's pack on its device
        (dist/profilers.py's subclass shards it instead)."""
        self.index = build_seed_index(self.pack, k=seed_params.k)
        return Aligner(self.pack, self.index, scoring, seed_params,
                       max_read_len=max_read_len, device=self.device)

    def run(self, read_paths, max_reads=None, trim=0, batch_size: int = 8192,
            gap_cap: Optional[int] = None, checkpoint_path=None,
            align_only: bool = False, paired: bool = False,
            interleaved: bool = False, read_length=None) -> Optional[Dict]:
        """Device-resident pileup: gapless kept reads scatter-add their
        bases into the [4 x (G+1)] device counts (device_steps.
        snps_update, in place every batch); the rare gapped reads spill
        to a device staging buffer, drained to the host as it fills, and
        get the exact oracle traceback once, after the stream. Batches
        parse and upload in a background thread; with checkpoint_path
        the state persists periodically (crash recovery and the
        reference's --align / --pileup stage split). With paired,
        read_paths is [m1, m2], or [m1] with interleaved. Traced as the
        span profile.sample, the root of the run's spans."""
        with tracing.span(tracing.SAMPLE, path="snps"):
            host = self._accumulate(read_paths, max_reads, trim, batch_size,
                                    gap_cap, checkpoint_path, paired=paired,
                                    interleaved=interleaved,
                                    read_length=read_length)
            if align_only:
                return None
            return self._finalize(host)

    def _accumulate(self, read_paths, max_reads, trim, batch_size,
                    gap_cap=None, checkpoint_path=None,
                    checkpoint_every: int = 64, paired: bool = False,
                    interleaved: bool = False, read_length=None) -> Dict:
        from midas_tpu_torch.io.prefetch import prefetch_device_batches
        from midas_tpu_torch.profile import checkpoint as ckpt
        from midas_tpu_torch.profile import device_steps as ds

        al = self.aligner
        L = al.max_read_len
        dev = self.device
        batch_size, cap = self._staging(batch_size, gap_cap, paired)
        state = self._init_state(cap)
        contig_species = torch.from_numpy(
            self.contig_species.astype(np.int64)).to(dev)
        smin_table = torch.from_numpy(
            ds.score_min_table(al.scoring, L)).to(dev)
        skip = 0
        fp = None
        drained: List[Dict[str, np.ndarray]] = []   # host gap rows

        def drain():
            # traced as profile.drain (attr rows); counter snps.gap_rows
            with tracing.span("profile.drain") as sp:
                spill, n = ds.sliced_spill_host(
                    {k: getattr(state, k) for k in ds.GAP_FIELDS},
                    state.gap_n, cap)
                sp.set(rows=n)
                tracing.count("snps.gap_rows", n)
                if n > cap:
                    raise RuntimeError(
                        f"gapped spill staging overflow ({n} > {cap}); "
                        "cap must exceed the per-drain row bound")
                if n:
                    drained.append(spill)
                state.gap_n.zero_()

        def gap_rows() -> Dict[str, np.ndarray]:
            if not drained:
                return dict(gap_codes=np.full((0, L), 4, np.int8),
                            gap_quals=np.zeros((0, L), np.int8),
                            gap_meta=np.zeros((0, 4), np.int32))
            return {k: np.concatenate([d[k] for d in drained])
                    for k in ds.GAP_FIELDS}

        def snapshot() -> Dict[str, np.ndarray]:
            drain()
            h = self._state_host(state)
            rows = gap_rows()
            h.update(rows)
            h["gap_n"] = np.int64(rows["gap_codes"].shape[0])
            return h

        if checkpoint_path:
            fp = self._fingerprint(read_paths, max_reads, trim, batch_size,
                                   cap, paired, interleaved, read_length)
            got = ckpt.load(checkpoint_path, fp)
            if got is not None:
                arrays, meta = got
                # counters and counts go back to the device; checkpointed
                # gap rows stay on the host (they may exceed the staging
                # capacity), as midas_tpu restores them
                state = self._restore_state(dict(arrays, **gap_rows(),
                                                 gap_n=0), cap)
                if arrays["gap_codes"].shape[0]:
                    drained.append({k: arrays[k] for k in ds.GAP_FIELDS})
                skip = int(meta["batches_done"])

        last_index = skip - 1
        rows_bound = 0   # worst-case spill rows since the last drain
        batches = select_batches(read_paths, batch_size, L, max_reads,
                                 paired, interleaved,
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
                self._snps_step(state, contig_species, codes, quals,
                                lengths, mean_qual, db.n_reads, smin_table,
                                bool(paired))
            rows_bound += db.n_reads
            if rows_bound > cap - batch_size:
                drain()
                rows_bound = 0
            if checkpoint_path and (db.index + 1) % checkpoint_every == 0:
                rows_bound = 0
                ckpt.save(checkpoint_path, snapshot(),
                          dict(fingerprint=fp, batches_done=db.index + 1,
                               guard=self._guard()))
        host = snapshot()
        if checkpoint_path:
            ckpt.save(checkpoint_path, host,
                      dict(fingerprint=fp, batches_done=last_index + 1,
                           guard=self._guard()))
        return host

    def _staging(self, batch_size: int, gap_cap, paired: bool):
        """(the batch size the stream is read at, the gapped-row staging
        capacity). The capacity is not a hard cap: the buffer drains to
        the host whenever the worst-case row count since the last drain
        approaches it, so any number of gapped reads completes; it holds
        at least two batches, so a drain always fits one."""
        return batch_size, max(gap_cap or GAP_CAP, 2 * batch_size)

    def _init_state(self, cap: int):
        from midas_tpu_torch.profile import device_steps as ds

        return ds.snps_init(self.pack.total_len, len(self.species_ids), cap,
                            self.aligner.max_read_len, self.device)

    def _restore_state(self, arrays: Dict, cap: int):
        """Device state from a checkpoint's arrays (their gap rows
        emptied: those stay on the host)."""
        from midas_tpu_torch.profile import device_steps as ds

        return ds.snps_state_restore(arrays, cap, self.device)

    def _state_host(self, state) -> Dict[str, np.ndarray]:
        from midas_tpu_torch.profile import device_steps as ds

        return ds.snps_state_host(state)

    def _snps_step(self, state, contig_species, codes, quals, lengths,
                   mean_qual, n_reads, smin_table, paired: bool) -> None:
        """One pileup batch, state updated in place."""
        from midas_tpu_torch.profile import device_steps as ds

        al = self.aligner
        ds.snps_update(
            state, al.index_arrays, al.pack_arrays, contig_species, codes,
            quals, lengths, mean_qual, n_reads, scoring=al.scoring,
            seed_params=al.seed_params, max_len=al.max_read_len,
            mapid=float(self.mapid), readq=float(self.readq),
            min_mapq=int(self.mapq), baseq=int(self.baseq),
            aln_cov=float(self.aln_cov), smin_table=smin_table,
            paired=paired)

    def _fingerprint(self, read_paths, max_reads, trim, batch_size, cap,
                     paired=False, interleaved=False,
                     read_length=None) -> str:
        from midas_tpu_torch.profile import checkpoint as ckpt

        return ckpt.fingerprint(
            kind="snps", schema=2,  # 2: quality-scaled --mp/--np
            paths=list(map(str, np.atleast_1d(read_paths))),
            max_reads=max_reads, trim=trim, batch_size=batch_size,
            mapid=self.mapid, readq=self.readq, mapq=self.mapq,
            baseq=self.baseq, aln_cov=self.aln_cov, cap=cap,
            species=self.species_ids, paired=paired,
            interleaved=interleaved, read_length=read_length)

    def _guard(self) -> Dict:
        """Finalize-relevant parameters persisted in checkpoint meta (see
        checkpoint.load_guarded)."""
        return dict(kind="snps", mapid=self.mapid, readq=self.readq,
                    mapq=self.mapq, baseq=self.baseq, aln_cov=self.aln_cov,
                    mode=self.mode,
                    species=list(self.species_ids),
                    total_len=int(self.pack.total_len))

    def finalize_from_checkpoint(self, checkpoint_path,
                                 force: bool = False) -> Dict:
        """--pileup without --align (the reference's equivalent reads
        temp/genomes.bam, scripts/run_midas.py:567-604), erroring when
        the state was written under different filter params / species /
        pack geometry."""
        from midas_tpu_torch.profile import checkpoint as ckpt

        got = ckpt.load_guarded(checkpoint_path, self._guard(), force=force)
        if got is None:
            sys.exit(f"\nError: no usable alignment state at {checkpoint_path}\n"
                     "Run with --align first\n")
        return self._finalize(got[0])

    @tracing.traced("profile.finalize")
    def _finalize(self, host: Dict) -> Dict:
        G = self.pack.total_len
        S = len(self.species_ids)
        aligned_reads = np.asarray(host["aligned_reads"][:S]).astype(np.int64)
        mapped_reads = np.asarray(host["mapped_reads"][:S]).astype(np.int64)

        # the exact host traceback of the spilled gapped reads, under the
        # scoring the device DP used (quality-scaled mismatches, read-N
        # penalty)
        n_gapped = int(host["gap_n"])
        gap_codes = np.asarray(host["gap_codes"])
        gap_quals = np.asarray(host["gap_quals"])
        gap_meta = np.asarray(host["gap_meta"])
        queries, windows, los, qpens = [], [], [], []
        scoring = self.aligner.scoring
        for r in range(gap_codes.shape[0]):
            ci, tstart, tend, qlen = (int(x) for x in gap_meta[r])
            seq_lo = int(self.pack.offsets[ci])
            lo = max(seq_lo + tstart - 8, 0)
            hi = min(seq_lo + tend + 8, G)
            queries.append(gap_codes[r, :qlen])
            windows.append(self.pack.codes[lo:hi])
            los.append(lo)
            if scoring.qual_scaled:
                # the spilled quals are strand-adjusted like the codes;
                # the same --mp table the device DP scored with
                q = np.minimum(gap_quals[r, :qlen].astype(np.int64), 40)
                mx, mn = -scoring.mismatch, scoring.mm_min
                qpens.append(mn + ((mx - mn) * q) // 40)
        adds = []
        with tracing.span("snps.oracle", rows=len(queries)):
            for r, a in enumerate(align_oracle_batch(
                    queries, windows, scoring,
                    qpens=qpens if scoring.qual_scaled else None)):
                qlen = len(queries[r])
                m = a.qpos_to_tpos(qlen)
                qpos = np.flatnonzero(m >= 0)
                tpos = los[r] + m[qpos]
                base = gap_codes[r, qpos]
                mask = (gap_quals[r, qpos] >= self.baseq) & (base < 4)
                adds.append((base[mask], tpos[mask]))
        counts = np.asarray(host["counts"]).reshape(4, G + 1)[:, :G].copy()
        for base, tpos in adds:
            np.add.at(counts, (base, tpos), 1)

        self.counts = counts
        self.stats = dict(aligned_reads=aligned_reads,
                          mapped_reads=mapped_reads, n_gapped=n_gapped)
        return dict(counts=counts, **self.stats)

    @tracing.traced("write.results", path="snps")
    def write_results(self, outdir: str) -> Dict[str, dict]:
        """Per-species .snps.gz over every genomic site + summary.txt
        (snps.py:164-262)."""
        depth_all = self.counts.sum(axis=0)
        summaries = {}
        for si, sid in enumerate(self.species_ids):
            self.write_sites(outdir, si, depth_all)
            genome_length = covered = total_depth = 0
            for ci in self._contigs(si):
                d = depth_all[self.pack.offsets[ci]: self.pack.offsets[ci + 1]]
                genome_length += len(d)
                covered += int((d > 0).sum())
                total_depth += int(d.sum())
            summaries[sid] = dict(
                genome_length=genome_length,
                covered_bases=covered,
                fraction_covered=(covered / float(genome_length)
                                  if genome_length else 0),
                mean_coverage=total_depth / float(covered) if covered else 0,
                aligned_reads=int(self.stats["aligned_reads"][si]),
                mapped_reads=int(self.stats["mapped_reads"][si]),
            )
        with open(os.path.join(outdir, "snps/summary.txt"), "w") as f:
            fields = ["species_id", "genome_length", "covered_bases",
                      "fraction_covered", "mean_coverage", "aligned_reads",
                      "mapped_reads"]
            f.write("\t".join(fields) + "\n")
            for sid in self.species_ids:
                s = summaries[sid]
                f.write("\t".join(str(x) for x in [
                    sid, s["genome_length"], s["covered_bases"],
                    s["fraction_covered"], s["mean_coverage"],
                    s["aligned_reads"], s["mapped_reads"]]) + "\n")
        return summaries

    def write_sites(self, outdir: str, si: int,
                    depth_all: np.ndarray) -> str:
        """<outdir>/snps/output/<species>.snps.gz for species index si:
        one row per site of its contigs, in sorted contig id order (the
        reference's order, snps.py:185). The native writer
        (io.native.write_sites_gz) formats and deflates the rows at
        level 9 in fixed chunks on the process's cores, one gzip member;
        without the native library, rows are formatted from Python ints
        (.tolist()), which print as midas_tpu's numpy scalars do, and
        written through gzip.open at level 9. The decompressed bytes are
        the same. depth_all is self.counts.sum(axis=0). Returns the
        file's path. Traced as write.sites (attrs species, writer
        "native" or "python", sites; native: threads)."""
        os.makedirs(os.path.join(outdir, "snps/output"), exist_ok=True)
        path = os.path.join(outdir,
                            f"snps/output/{self.species_ids[si]}.snps.gz")
        header = "\t".join(["ref_id", "ref_pos", "ref_allele", "depth",
                            "count_a", "count_c", "count_g",
                            "count_t"]) + "\n"
        contigs = [(self.pack.names[ci], int(self.pack.offsets[ci]),
                    int(self.pack.offsets[ci + 1]))
                   for ci in self._contigs(si)]
        lib = load_native()
        with tracing.span("write.sites", species=self.species_ids[si],
                          writer="python" if lib is None else "native",
                          sites=sum(hi - lo for _, lo, hi in contigs)) as sp:
            if lib is None:
                with iopen(path, "wt") as f:
                    f.write(header)
                    for name, lo, hi in contigs:
                        if hi > lo:
                            f.write(_site_rows(name, self.pack.codes[lo:hi],
                                               depth_all[lo:hi],
                                               self.counts[:, lo:hi]))
            else:
                st = write_sites_gz(lib, path, header, contigs,
                                    self.pack.codes, depth_all, self.counts,
                                    len(os.sched_getaffinity(0)))
                sp.set(threads=st["threads"])
                tracing.count("write.native_sites", st["sites"])
                for k in ("chunks", "threads", "text_bytes", "gz_bytes"):
                    tracing.count(f"write.{k}", st[k])
        return path

    def _contigs(self, si: int) -> List[int]:
        """Species si's contig indices in sorted contig id order."""
        return sorted(np.flatnonzero(self.contig_species == si).tolist(),
                      key=lambda ci: self.pack.names[ci])


def _site_rows(name: str, codes: np.ndarray, depth: np.ndarray,
               counts: np.ndarray) -> str:
    """One contig's rows: name, 1-based position, reference allele,
    depth and the four base counts, newline-terminated."""
    alleles = CODE_TO_BASE[codes.astype(np.int64)].tobytes().decode("ascii")
    a, c, g, t = (counts[j].tolist() for j in range(4))
    prefix = name + "\t"
    return "".join(
        f"{prefix}{p}\t{r}\t{dd}\t{aa}\t{cc}\t{gg}\t{tt}\n"
        for p, r, dd, aa, cc, gg, tt in zip(
            range(1, len(alleles) + 1), alleles, depth.tolist(), a, c, g, t))


def _count_fasta_records(path: str) -> int:
    from midas_tpu_torch.io.seqio import read_fastx
    with iopen(path) as fp:
        return sum(1 for _ in read_fastx(fp))


def run_snps(args: Dict) -> Optional[SnpsProfiler]:
    """The snps pipeline end to end, with the reference output layout and
    per-stage timing/memory prints (snps.py:268-305). args["device"]
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
    os.makedirs(os.path.join(outdir, "snps/temp"), exist_ok=True)
    os.makedirs(os.path.join(outdir, "snps/output"), exist_ok=True)
    db = Database(args["db"])
    species_ids = resolve_species_list(args, db, "snps")
    if not species_ids:
        sys.exit("\nError: no species satisfied your selection criteria.\n"
                 "Try running with more lenient parameters "
                 "(e.g. --species_cov, --species_topn, or --species_id)")
    # stage gating: --build_db alone only persists the species list
    if args.get("build_db") and not (args.get("align") or args.get("call")):
        return None

    state_path = os.path.join(outdir, "snps/temp/state.npz")
    scan_paths = [p for p in (args.get("m1"), args.get("m2")) if p]
    max_read_len = (detect_max_read_len(scan_paths, args.get("read_length"))
                    if scan_paths else 128)
    paired = bool(args.get("m2")) or bool(args.get("interleaved"))
    if multi:
        # the driver always runs the FULL align+pileup pipeline; stage
        # splits and checkpoints are single-process features
        if not (args.get("build_db") and args.get("align")
                and args.get("call")):
            sys.exit("\nError: multi-host snps runs the full pipeline; "
                     "--build_db/--align/--pileup stage splits are "
                     "single-host features\n")
        with stage_timer(f"Pileup over {driver.process_count()} ranks", log):
            driver.run_snps_multihost(
                db, scan_paths, species_ids, outdir=outdir,
                batch_size=batch_size, max_reads=args.get("max_reads"),
                trim=args.get("trim", 0), paired=paired,
                interleaved=bool(args.get("interleaved")),
                read_length=args.get("read_length"),
                mapid=args.get("mapid", 94.0), readq=args.get("readq", 20.0),
                mapq=args.get("mapq", 20), baseq=args.get("baseq", 30),
                aln_cov=args.get("aln_cov", 0.75),
                mode=args.get("mode", "global"), max_read_len=max_read_len,
                device=device)
        if args.get("remove_temp") and driver.process_index() == 0:
            import shutil
            shutil.rmtree(os.path.join(outdir, "snps/temp"),
                          ignore_errors=True)
        return None

    with stage_timer("Building genome database", log):
        profiler = SnpsProfiler(
            db, species_ids,
            mapid=args.get("mapid", 94.0), readq=args.get("readq", 20.0),
            mapq=args.get("mapq", 20), baseq=args.get("baseq", 30),
            aln_cov=args.get("aln_cov", 0.75),
            mode=args.get("mode", "global"), max_read_len=max_read_len,
            device=device,
        )
    if args.get("align") or args.get("build_db"):
        paths = [args["m1"]]
        if args.get("m2"):
            paths.append(args["m2"])
        with stage_timer("Aligning reads to representative genomes", log):
            profiler.run(paths, max_reads=args.get("max_reads"),
                         trim=args.get("trim", 0), batch_size=batch_size,
                         paired=paired,
                         interleaved=bool(args.get("interleaved")),
                         read_length=args.get("read_length"),
                         checkpoint_path=state_path,
                         align_only=not args.get("call"))
        if not args.get("call"):
            return profiler
        with stage_timer("Counting alleles", log):
            profiler.write_results(outdir)
    elif args.get("call"):
        with stage_timer("Counting alleles", log):
            profiler.finalize_from_checkpoint(state_path,
                                              force=bool(args.get("force")))
            profiler.write_results(outdir)
    if args.get("remove_temp"):
        import shutil
        shutil.rmtree(os.path.join(outdir, "snps/temp"))
    return profiler
