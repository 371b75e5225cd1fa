"""Species abundance profiling from universal single-copy marker genes.

Re-implementation of midas/run/species.py on PyTorch: reads are aligned
to the 15-family marker database with the seed-and-extend aligner
(replacing the `stream_seqs | hs-blastn` pipeline at species.py:29-49),
then classified with the reference's exact filter semantics:

- per-marker-family %id cutoffs (species.py:72-76, get_markers :121-132)
- query coverage >= aln_cov, default 0.75 (:77-78)
- hs-blastn's -evalue 1e-3 gate, as an integer minimum score (:39-46)
- best score per read with ties kept (:79-84)
- unique reads counted per species; ambiguous reads assigned
  probabilistically in proportion to unique counts (:87-119). The
  reference's RNG is unseeded (np.random.choice at :117); we seed it
  (default 42) so runs are reproducible — documented divergence.
- coverage = aligned bp / total marker gene length, relative abundance
  = coverage / total coverage (:141-163)
- species_profile.txt sorted by read count descending, species_info
  file order breaking ties (:165-175)

Output is byte-identical to midas_tpu's single-device path on the same
inputs, with or without --m8 (the host classifier and the BLAST
outfmt-6 writer). Under a launch of several processes, run_species
routes to the data-parallel driver (dist/driver.py), one rank per card.
"""

from __future__ import annotations

import os
import random
import sys
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from midas_tpu_torch.align.params import MARKER_SCORING
from midas_tpu_torch.align.pipeline import (Aligner, AlignmentResult,
                                            resolve_device)
from midas_tpu_torch.align.seed import SeedParams
from midas_tpu_torch.db.index import build_seed_index
from midas_tpu_torch.db.layout import Database
from midas_tpu_torch.db.refpack import pack_from_fasta
from midas_tpu_torch.dist import driver
from midas_tpu_torch.io.batch import load_read_batches
from midas_tpu_torch.io.seqio import parse_file

AMB_CAP = 262144   # ambiguous-read staging rows between drains


class SpeciesProfiler:
    """Aligner + classifier bound to one database's marker genes, its
    tensors on one device (the card unless device="cpu")."""

    def __init__(
        self,
        db: Database,
        mapid: Optional[float] = None,
        aln_cov: float = 0.75,
        seed: int = 42,
        seed_params: Optional[SeedParams] = None,
        max_read_len: int = 128,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.db = db
        self.aln_cov = aln_cov
        self.seed = seed
        self.marker_info = db.marker_info()
        self.cutoffs = db.marker_cutoffs(override=mapid)
        self.pack = pack_from_fasta(db.marker_fasta())
        sp = seed_params or SeedParams(num_cands=8, max_hits=32)
        self.index = build_seed_index(self.pack, k=sp.k)
        self.aligner = Aligner(self.pack, self.index, MARKER_SCORING, sp,
                               max_read_len=max_read_len, device=self.device)
        # per-target-sequence columns, aligned with pack.names
        self.species_order = list(db.species_info())  # file order
        sp_index = {s: i for i, s in enumerate(self.species_order)}
        self.seq_species = np.array(
            [sp_index[self.marker_info[g]["species_id"]] for g in self.pack.names],
            dtype=np.int32,
        )
        self.seq_cutoff = np.array(
            [self.cutoffs[self.marker_info[g]["marker_id"]] for g in self.pack.names],
            dtype=np.float32,
        )
        # total marker gene length per species (species.py:134-139)
        self.total_gene_length = np.zeros(len(self.species_order), dtype=np.float64)
        for r in self.marker_info.values():
            self.total_gene_length[sp_index[r["species_id"]]] += int(r["gene_length"])

    def run(
        self,
        read_paths,
        read_length: Optional[int] = None,
        max_reads: Optional[int] = None,
        batch_size: int = 8192,
        m8_path: Optional[str] = None,
        checkpoint_path: Optional[str] = None,
    ) -> Dict:
        """Align + classify all reads. Returns the abundance dict:
        species_id -> {count, cov, rel_abun}.

        Without m8 output the classifier runs on the profiler's device
        (profile.device_steps.species_update): per-species unique
        counts/bp accumulate in device state updated in place, and only
        ambiguous best-hit sets (which go through the reference's host
        RNG assignment, species.py:104-119) come back. With m8_path the
        full alignment results are needed on the host for the outfmt-6
        rows, so each batch is read back and the host classifier runs
        instead (no checkpoint); both paths give equal abundances and
        stats."""
        if m8_path is None:
            unique_count, unique_bp, ambiguous = self._run_device(
                read_paths, read_length, max_reads, batch_size,
                checkpoint_path=checkpoint_path)
        else:
            unique_count, unique_bp, ambiguous = self._run_host(
                read_paths, read_length, max_reads, batch_size, m8_path)
        return self.assign_and_normalize(unique_count, unique_bp, ambiguous)

    def assign_and_normalize(self, unique_count, unique_bp, ambiguous) -> Dict:
        """RNG assignment of ambiguous reads + coverage normalization —
        the deterministic host tail (midas_tpu's, unchanged)."""
        # Rows must be consumed in GLOBAL STREAM ORDER — the reference
        # draws its RNG choices sequentially while parsing the m8 stream
        # (species.py:104-119). Items are (seq_ids, sp_ids, alns[, ord]);
        # 3-tuples keep their list position as the key.
        ambiguous = [
            (t[0], t[1], t[2], (int(t[3]) if len(t) > 3 else r))
            for r, t in enumerate(ambiguous)]
        ambiguous.sort(key=lambda t: t[3])

        # probabilistic assignment of ambiguous reads (species.py:104-119),
        # vectorized: the reference draws one np.random.choice per read
        # with weights from the FIXED unique counts, so every draw is
        # independent — one random_sample over the weighted rows
        # reproduces the sequential per-row consumption exactly (MT19937
        # random_sample(n) == n x random_sample(1)), and the
        # searchsorted-on-normalized-cumsum below is choice()'s own
        # sampling algorithm. Zero-weight rows consume the separate
        # python Random stream, scalar, as the reference does.
        rng = np.random.RandomState(self.seed)
        pyrng = random.Random(self.seed)
        count = unique_count.copy()
        bp = unique_bp.copy()
        n_amb = len(ambiguous)
        if n_amb:
            # canonicalize tie-set order by pack (subject) index: the
            # real hs-blastn emits equal-score hits in subject-index
            # order, the reference's RNG draw consumes species ids in that
            # m8 order (species.py:104-119), and our pack preserves
            # phyeco.fa order — so sorting by seq index makes the seeded
            # draw byte-identical to the reference
            widths = np.fromiter((len(t[1]) for t in ambiguous),
                                 count=n_amb, dtype=np.int64)
            wmax = int(widths.max())
            sp_m = np.zeros((n_amb, wmax), dtype=np.int64)
            aln_m = np.zeros((n_amb, wmax), dtype=np.float64)
            for r, (seq_ids, sp_ids, alns, _ord) in enumerate(ambiguous):
                o = np.argsort(seq_ids, kind="stable")
                sp_m[r, : len(sp_ids)] = sp_ids[o]
                aln_m[r, : len(alns)] = alns[o]
            in_row = np.arange(wmax)[None, :] < widths[:, None]
            W = np.where(in_row, unique_count[sp_m].astype(np.float64), 0.0)
            rowsum = W.sum(axis=1)
            nz = rowsum > 0
            # weighted rows: replicate RandomState.choice(p=probs) —
            # probs = W/sum, cdf = cumsum, cdf /= cdf[-1],
            # searchsorted(cdf, u, side='right')
            j = np.zeros(n_amb, dtype=np.int64)
            if nz.any():
                probs = W[nz] / rowsum[nz][:, None]
                cdf = probs.cumsum(axis=1)
                cdf /= cdf[:, -1][:, None]
                u = rng.random_sample(int(nz.sum()))
                j_draw = (cdf <= u[:, None]).sum(axis=1)  # side='right'
                # the reference then takes the FIRST tie-set index whose
                # species equals the drawn one (species ids can repeat
                # across markers in one tie set)
                drawn_sp = np.take_along_axis(sp_m[nz], j_draw[:, None],
                                              axis=1)
                j[nz] = np.argmax(sp_m[nz] == drawn_sp, axis=1)
            zi = np.flatnonzero(~nz)
            for r in zi:
                j[r] = pyrng.randrange(int(widths[r]))
            sp_j = np.take_along_axis(sp_m, j[:, None], axis=1)[:, 0]
            aln_j = np.take_along_axis(aln_m, j[:, None], axis=1)[:, 0]
            np.add.at(count, sp_j, 1)
            np.add.at(bp, sp_j, aln_j)

        # normalize (species.py:141-163). total_cov must be the BUILTIN
        # sum over species_info order: the reference computes
        # `sum([_['cov'] for _ in species_abundance.values()])`
        # (species.py:158) and CPython >= 3.12's float sum() is
        # Neumaier-compensated — a naive += loop differs in the last ulp
        cov = np.where(self.total_gene_length > 0, bp / np.maximum(self.total_gene_length, 1), 0.0)
        total_cov = sum([float(cov[i])
                         for i in range(len(self.species_order))])
        abundance = {}
        for i, sid in enumerate(self.species_order):
            abundance[sid] = {
                "count": int(count[i]),
                "cov": float(cov[i]),
                "rel_abun": float(cov[i]) / total_cov if total_cov > 0 else 0,
            }
        return abundance

    def _run_host(self, read_paths, read_length, max_reads, batch_size,
                  m8_path) -> Tuple[np.ndarray, np.ndarray, List]:
        """Host-side classifier over each batch's read-back alignments
        (Aligner.align_batch; the DP runs on the profiler's device), with
        the m8 rows written as it goes. Semantics: species.py:64-119."""
        n_species = len(self.species_order)
        unique_count = np.zeros(n_species, dtype=np.int64)
        unique_bp = np.zeros(n_species, dtype=np.float64)
        ambiguous: List[Tuple] = []
        total_reads = total_bp = total_alns = 0
        with open(m8_path, "w") as m8:
            for bi, batch in enumerate(load_read_batches(
                read_paths, batch_size=batch_size,
                max_len=self.aligner.max_read_len,
                read_length=read_length, max_reads=max_reads,
            )):
                total_reads += batch.n_reads
                total_bp += int(batch.lengths[: batch.n_reads].sum())
                res = self.aligner.align_batch(batch)
                pid = res.blast_pid
                aln = res.aln_cols
                cutoff = self.seq_cutoff[
                    np.clip(res.seq_idx, 0, len(self.seq_cutoff) - 1)]
                qlens = np.asarray(batch.lengths)[:, None]
                qcov = aln / np.maximum(qlens, 1)
                # hs-blastn's -evalue 1e-3 gate, as a per-read float64
                # score floor (the device path's twin is the integer
                # evalue_min_score table: the same test on integer scores)
                ethr = MARKER_SCORING.evalue_score_threshold(
                    np.maximum(qlens, 1).astype(np.float64),
                    float(self.pack.total_len))
                keep = (res.valid & (res.score > 0) & (pid >= cutoff)
                        & (qcov >= self.aln_cov) & (res.score >= ethr))
                total_alns += int(res.valid.sum())
                self._write_m8(m8, batch, res)
                scores = np.where(keep, res.score, -np.inf)
                best = scores.max(axis=1)
                has_hit = np.isfinite(best)
                best_mask = keep & (scores == best[:, None])
                n_best = best_mask.sum(axis=1)
                sp_of = self.seq_species[
                    np.clip(res.seq_idx, 0, len(self.seq_species) - 1)]
                for i in np.flatnonzero(has_hit[: batch.n_reads]):
                    cols = np.flatnonzero(best_mask[i])
                    if n_best[i] == 1:
                        c = cols[0]
                        unique_count[sp_of[i, c]] += 1
                        unique_bp[sp_of[i, c]] += aln[i, c]
                    else:
                        ambiguous.append((res.seq_idx[i, cols],
                                          sp_of[i, cols], aln[i, cols],
                                          bi * batch_size + int(i)))
        self.stats = dict(total_reads=total_reads, total_bp=total_bp,
                          total_alns=total_alns)
        return unique_count, unique_bp, ambiguous

    def _run_device(self, read_paths, read_length, max_reads, batch_size,
                    amb_cap: Optional[int] = None,
                    checkpoint_path: Optional[str] = None,
                    checkpoint_every: int = 64,
                    ) -> Tuple[np.ndarray, np.ndarray, List]:
        """Device-resident classifier: one species_update per batch,
        state updated in place, no per-batch readback. Input batches
        parse+upload in a background thread (io/prefetch.py) so H2D
        rides under the previous batch's compute. With checkpoint_path,
        a sliced state snapshot persists every checkpoint_every batches
        and a rerun resumes from it byte-identically.

        The ambiguous-read spill buffer is a fixed-size STAGING area,
        not a hard cap: whenever the worst-case row count since the
        last drain approaches capacity, the occupied rows are pulled to
        host and the device cursor resets — so a run over any number of
        reads completes without tuning the capacity."""
        from midas_tpu_torch.io.prefetch import prefetch_device_batches
        from midas_tpu_torch.profile import checkpoint as ckpt
        from midas_tpu_torch.profile import device_steps as ds

        dev = self.device
        n_species = len(self.species_order)
        cap = amb_cap or AMB_CAP
        cap = max(cap, 2 * batch_size)   # a drain must always fit a batch
        al = self.aligner
        C = al.seed_params.num_cands
        state = ds.species_init(n_species, C, cap, dev)
        seq_species = torch.from_numpy(self.seq_species).to(dev)
        seq_cutoff = torch.from_numpy(self.seq_cutoff).to(dev)
        min_score = torch.from_numpy(MARKER_SCORING.evalue_min_score(
            np.maximum(np.arange(al.max_read_len + 1), 1),
            float(self.pack.total_len))).to(dev)
        total_reads = total_bp = 0
        skip = 0
        fp = None
        drained: List[Dict[str, np.ndarray]] = []   # host amb rows, stream order

        def drain(state):
            """Pull occupied spill rows to host, reset the device cursor."""
            spill, n = ds.sliced_spill_host(
                {k: getattr(state, k) for k in ds.SPILL_FIELDS},
                state.amb_n, cap)
            if n > cap:
                raise RuntimeError(
                    f"ambiguous spill staging overflow ({n} > {cap}); "
                    "cap must exceed the per-drain row bound")
            if n:
                drained.append(spill)
            state.amb_n.zero_()

        def full_rows() -> Dict[str, np.ndarray]:
            if not drained:
                return {k: (np.zeros(0, np.int64) if k == "amb_ord" else
                            np.zeros((0, C), dtype=np.int32))
                        for k in ds.SPILL_FIELDS}
            return {k: np.concatenate([d[k] for d in drained])
                    for k in ds.SPILL_FIELDS}

        if checkpoint_path:
            fp = ckpt.fingerprint(
                kind="species", schema=3,  # schema 3: + amb_ord stream rank
                paths=list(map(str, np.atleast_1d(read_paths))),
                read_length=read_length, max_reads=max_reads,
                batch_size=batch_size, aln_cov=self.aln_cov,
                cutoffs=sorted(self.cutoffs.items()),
                num_cands=C, cap=cap,
                # a rank's stride (dist/driver.py::_stride_setup): a
                # rerun with another rank count must not resume it
                **({"stride": self._stride}
                   if getattr(self, "_stride", None) else {}))
            got = ckpt.load(checkpoint_path, fp)
            if got is not None:
                arrays, meta = got
                # restore counters to the device; checkpointed amb rows
                # stay host-side (they may exceed the staging capacity)
                state = ds.species_state_restore(
                    {**arrays, **{k: arrays[k][:0] for k in ds.SPILL_FIELDS},
                     "amb_n": 0}, cap, dev)
                if arrays["amb_sp"].shape[0]:
                    drained.append({k: arrays[k] for k in ds.SPILL_FIELDS})
                skip = int(meta["batches_done"])
                total_reads = int(meta["total_reads"])
                total_bp = int(meta["total_bp"])

        batches = load_read_batches(
            read_paths, batch_size=batch_size,
            max_len=al.max_read_len,
            read_length=read_length, max_reads=max_reads,
        )
        if getattr(self, "_batch_filter", None):
            batches = self._batch_filter(batches)  # multi-process striding
        last_index = skip - 1
        rows_bound = 0   # worst-case spill rows since the last drain
        for db in prefetch_device_batches(batches, ("codes", "lengths"),
                                          device=dev, skip_batches=skip):
            last_index = db.index
            total_reads += db.n_reads
            total_bp += db.total_bp
            codes, lengths = db.arrays
            ds.species_update(
                state, al.index_arrays, al.pack_arrays,
                seq_species, seq_cutoff, codes, lengths, db.n_reads,
                db.global_index * batch_size,
                scoring=al.scoring, seed_params=al.seed_params,
                max_len=al.max_read_len, aln_cov=float(self.aln_cov),
                n_species=n_species, min_score=min_score)
            rows_bound += db.n_reads
            if rows_bound > cap - batch_size:
                drain(state)
                rows_bound = 0
            if checkpoint_path and (db.index + 1) % checkpoint_every == 0:
                drain(state)
                rows_bound = 0
                h = ds.species_state_host(state)
                rows = full_rows()
                h.update(rows)
                h["amb_n"] = np.int64(rows["amb_sp"].shape[0])
                ckpt.save(checkpoint_path, h, dict(
                    fingerprint=fp, batches_done=db.index + 1,
                    total_reads=total_reads, total_bp=total_bp))
        drain(state)
        host = ds.species_state_host(state)
        rows = full_rows()
        host.update(rows)
        amb_n = int(rows["amb_sp"].shape[0])
        host["amb_n"] = np.int64(amb_n)
        if checkpoint_path:
            # batches_done = consumed count, so rerunning a completed
            # run restores this state and the skip exhausts the stream —
            # byte-identical output, no double counting
            ckpt.save(checkpoint_path, host, dict(
                fingerprint=fp, batches_done=last_index + 1,
                total_reads=total_reads, total_bp=total_bp))
        unique_count = host["uniq_count"][:n_species].astype(np.int64)
        unique_bp = host["uniq_bp"][:n_species].astype(np.float64)
        ambiguous = []
        for r in range(amb_n):
            cols = np.flatnonzero(host["amb_sp"][r] >= 0)
            ambiguous.append((host["amb_seq"][r, cols],
                              host["amb_sp"][r, cols],
                              host["amb_bp"][r, cols].astype(np.float64),
                              int(host["amb_ord"][r])))
        self.stats = dict(total_reads=total_reads, total_bp=total_bp,
                          total_alns=int(host["total_alns"]))
        return unique_count, unique_bp, ambiguous

    def _write_m8(self, fh, batch, res: AlignmentResult) -> None:
        """BLAST outfmt-6-compatible rows for passing candidates, with the
        reference's renamed-query convention '{id}_{len}'
        (stream_seqs.py:59)."""
        dblen = self.pack.total_len
        for i in range(res.n_reads):
            qlen = int(batch.lengths[i])
            qname = f"{batch.names[i]}_{qlen}"
            for c in np.flatnonzero(res.valid[i]):
                if res.score[i, c] <= 0:
                    continue
                raw = float(res.score[i, c])
                bits = MARKER_SCORING.bitscore(raw)
                ev = MARKER_SCORING.evalue(raw, qlen, dblen)
                if ev > 1e-3:
                    # hs-blastn's -evalue 1e-3 emission gate
                    # (midas/run/species.py:39-46); immaterial above
                    # ~25 bp, but 14-mer seeds can hit fragments the
                    # binary's 28 bp word size never reports
                    continue
                strand = int(res.strand[i, c])
                ts, te = int(res.tstart[i, c]) + 1, int(res.tend[i, c])
                if strand:  # minus strand: m8 swaps target coords
                    ts, te = te, ts
                fh.write("\t".join(str(x) for x in [
                    qname, self.pack.names[res.seq_idx[i, c]],
                    f"{res.blast_pid[i, c]:.2f}", int(res.aln_cols[i, c]),
                    int(res.mismatches[i, c]), int(res.gap_opens[i, c]),
                    int(res.qstart[i, c]) + 1, int(res.qend[i, c]),
                    ts, te, f"{ev:.2g}", f"{bits:.1f}",
                ]) + "\n")


def write_abundance(outpath: str, abundance: Dict) -> None:
    """species_profile.txt writer, format-identical to species.py:165-175."""
    with open(outpath, "w") as f:
        f.write("\t".join(["species_id", "count_reads", "coverage", "relative_abundance"]) + "\n")
        order = sorted(abundance.items(), key=lambda kv: kv[1]["count"], reverse=True)
        for sid, v in order:
            f.write("\t".join(str(x) for x in [sid, v["count"], v["cov"], v["rel_abun"]]) + "\n")


def read_abundance(inpath: str) -> Dict[str, dict]:
    """Parse species_profile.txt (species.py:177-189)."""
    if not os.path.isfile(inpath):
        sys.exit(
            "\nCould not locate species profile: %s\n"
            "Try rerunning with run_midas.py species" % inpath
        )
    abun = {}
    for rec in parse_file(inpath):
        rec = dict(rec)
        if "count_reads" in rec:
            rec["count_reads"] = int(rec["count_reads"])
        if "coverage" in rec:
            rec["coverage"] = float(rec["coverage"])
        if "relative_abundance" in rec:
            rec["relative_abundance"] = float(rec["relative_abundance"])
        abun[rec["species_id"]] = rec
    return abun


def select_species(
    db: Database,
    outdir: str,
    species_cov: Optional[float] = None,
    species_topn: Optional[int] = None,
    species_id: Optional[List[str]] = None,
) -> List[str]:
    """Select species for genes/snps profiling — intersection of the
    requested criteria, minus exclude.txt (species.py:191-227)."""
    species_sets = []
    if species_cov is not None or species_topn is not None:
        abundance = read_abundance(os.path.join(outdir, "species/species_profile.txt"))
        if species_cov is not None:
            species_sets.append(
                {s for s, v in abundance.items() if v["coverage"] >= species_cov})
        if species_topn is not None:
            ranked = sorted(abundance.items(),
                            key=lambda kv: kv[1]["relative_abundance"], reverse=True)
            species_sets.append({s for s, _v in ranked[:species_topn]})
    if species_id:
        species_sets.append(set(species_id))
    if not species_sets:
        return []
    # sorted so the pack layout — and with it argmax tie-breaking among
    # equally-scoring hits — is independent of PYTHONHASHSEED; the
    # reference's unsorted list(set) makes its genes output run-order
    # dependent in the same way its RNG is unseeded (species.py:113-117)
    my_species = sorted(set.intersection(*species_sets))
    for bad in db.excluded_species():
        if bad in my_species:
            my_species.remove(bad)
    if not my_species:
        sys.exit("\nError: no species satisfied your selection criteria.\n")
    return my_species


def run_species(args: Dict) -> Dict:
    """The species pipeline end to end, with the reference's output layout
    (species.py:229-269): <outdir>/species/{species_profile.txt,
    temp/read_count.txt, temp/state.npz}. args["device"] picks the
    device (default "cuda"); batches hold common.BATCH_SIZE reads.

    The default path keeps the whole classifier on the device (no
    per-batch readback). `--m8` opts into writing BLAST outfmt-6 rows to
    temp/alignments.m8, which reads every alignment back to the host and
    writes no temp/state.npz; with --remove_temp it is ignored, as
    midas_tpu ignores it (the m8 file would live under temp/, which that
    flag deletes).

    Under a launch of several processes (torchrun, WORLD_SIZE > 1) it
    routes to the multi-process driver (dist/driver.py): each rank
    strides the shared read stream on its card, with its own checkpoint
    temp/state.rank{rank}.npz, the accumulators merge once at the end
    and rank 0 writes; --m8 (a per-read host readback) exits there, as
    in midas_tpu."""
    from midas_tpu_torch.io.batch import detect_max_read_len
    from midas_tpu_torch.profile import common
    from midas_tpu_torch.utils import stage_timer

    multi = common._multi_process()
    if multi and args.get("m8"):
        sys.exit("\nError: --m8 requires per-read host readback and "
                 "is a single-host feature\n")
    if multi:
        driver.initialize()
    device = resolve_device(args.get("device") or "cuda")
    batch_size = common.BATCH_SIZE
    outdir = args["outdir"]
    log = args.get("log")
    os.makedirs(os.path.join(outdir, "species/temp"), exist_ok=True)
    paths = [args["m1"]]
    if args.get("m2"):
        paths.append(args["m2"])

    if multi:
        pid, pcount = driver.process_index(), driver.process_count()
        with stage_timer(f"Profiling species over {pcount} ranks", log):
            abundance = driver.run_species_multihost(
                args["db"], paths, outdir=outdir, batch_size=batch_size,
                read_length=args.get("read_length"),
                max_reads=args.get("max_reads"),
                seed=args.get("seed", 42), mapid=args.get("mapid"),
                aln_cov=args.get("aln_cov", 0.75),
                checkpoint_path=os.path.join(
                    outdir, f"species/temp/state.rank{pid}.npz"),
                max_read_len=detect_max_read_len(paths,
                                                 args.get("read_length")),
                device=device)
        if args.get("remove_temp") and pid == 0:
            # the driver barriers after rank 0's writes, so this runs
            # only once every rank is done with temp/
            import shutil
            shutil.rmtree(os.path.join(outdir, "species/temp"),
                          ignore_errors=True)
        return abundance

    with stage_timer("Loading marker-gene database", log):
        db = Database(args["db"])
        profiler = SpeciesProfiler(
            db, mapid=args.get("mapid"), aln_cov=args.get("aln_cov", 0.75),
            seed=args.get("seed", 42),
            max_read_len=detect_max_read_len(paths,
                                             args.get("read_length")),
            device=device,
        )
    m8_path = (os.path.join(outdir, "species/temp/alignments.m8")
               if args.get("m8") and not args.get("remove_temp") else None)
    with stage_timer("Aligning reads to marker-genes database", log):
        abundance = profiler.run(
            paths, read_length=args.get("read_length"),
            max_reads=args.get("max_reads"), batch_size=batch_size,
            m8_path=m8_path,
            checkpoint_path=os.path.join(outdir, "species/temp/state.npz"),
        )
    with stage_timer("Estimating species abundance", log):
        with open(os.path.join(outdir, "species/temp/read_count.txt"), "w") as f:
            f.write(f"{profiler.stats['total_reads']}\t{profiler.stats['total_bp']}")
        write_abundance(os.path.join(outdir, "species/species_profile.txt"), abundance)
    if args.get("remove_temp"):
        import shutil
        shutil.rmtree(os.path.join(outdir, "species/temp"))
    return abundance
