"""Multi-process data-parallel driving on torch.distributed, one rank
per card — midas_tpu's dist/driver.py on PyTorch.

The reference never leaves one host (its concurrency is fork pools +
unix pipes, midas/utility.py:81-107); reads, though, are embarrassingly
parallel, so the multi-process design is pure data parallelism over the
read stream:

- every process joins the job through initialize() — under torchrun
  (`torchrun --nproc_per_node=N -m midas_tpu_torch.cli.run_midas ...`)
  from the launcher's environment — and drives one card, cuda:LOCAL_RANK
  modulo the host's card count (align/pipeline.py::resolve_device);
- each rank streams a disjoint shard of the input FASTQ(s) — whole
  files round-robin when there are enough plain files, batch striding
  over the shared stream otherwise — and profiles it on its card;
- the small accumulators (species unique counts/bp, per-gene counters,
  the snps [4 x (G+1)] counts) and the spill rows (ambiguous species
  reads, gapped snps reads) merge across ranks once, at the end of the
  stream, on the host;
- the ambiguous-read RNG assignment then runs identically on every
  rank (same seed, merged rows sorted back into stream order), so every
  rank computes the same result and rank 0 writes it.

The per-batch path is free of collectives: the only bytes between ranks
are the end-of-stream merge. With tp > 1 each rank's profiler holds its
pack and seed index as tp shards across a list of devices, driven by
the rank's one process (tensor parallelism: dist/sharded.py,
dist/species.py, dist/profilers.py), as midas_tpu's local mesh does;
striding and the merges are the same.
"""

from __future__ import annotations

import atexit
import datetime
import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

# Every collective here is a host-side merge of numpy arrays at the end
# of the stream (JAX's process_allgather returns numpy too), so the
# process group is gloo: it runs on CPU tensors, across hosts as well,
# and any number of ranks may share one card (NCCL refuses two ranks on
# one device).
BACKEND = "gloo"
# Seconds a collective (and the rendezvous) waits for the other ranks
# before it fails the run. A rank that dies closes its connections and
# fails its peers' next collective at once; a rank that hangs fails them
# after this long. Ranks that finish their share early wait at the merge
# for the slowest one, so the limit must cover a whole rank's stream.
DEFAULT_TIMEOUT_S = 1800.0


def _timeout() -> datetime.timedelta:
    return datetime.timedelta(seconds=DEFAULT_TIMEOUT_S)


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """Join the job's process group (gloo), with a timeout of
    DEFAULT_TIMEOUT_S seconds on every collective. With no
    arguments the launcher's environment says where (init_method
    env://: MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK, as torchrun sets
    them) — the counterpart of jax.distributed's auto-detection; with
    arguments, tcp://coordinator_address. A no-op for one process, or
    when the group already exists."""
    if dist.is_initialized():
        return
    if coordinator_address is None and num_processes is None \
            and process_id is None:
        if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
            return
        dist.init_process_group(BACKEND, init_method="env://",
                                timeout=_timeout())
        atexit.register(_shutdown)
        return
    if num_processes is not None and num_processes <= 1:
        return
    if None in (coordinator_address, num_processes, process_id):
        raise ValueError("initialize: give coordinator_address, "
                         "num_processes and process_id together, or none")
    dist.init_process_group(
        BACKEND, init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id, timeout=_timeout())
    atexit.register(_shutdown)


def _shutdown() -> None:
    """Tear the group down while the interpreter still runs: left to the
    interpreter's own teardown, a rank whose peer holding the store has
    already exited can abort (SIGABRT) after its work is done. No
    barrier here: a rank that exits on an error must not wait for its
    peers."""
    if dist.is_initialized():
        dist.destroy_process_group()


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def local_rank() -> Optional[int]:
    """This process's rank on its host: LOCAL_RANK as a launcher sets
    it, else the rank of an initialized group of several processes (all
    on one host), else None (not launched)."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    if process_count() > 1:
        return process_index()
    return None


def shard_read_paths(paths: Sequence[str], process_index: int,
                     process_count: int) -> List[str]:
    """Round-robin whole input files across ranks. With fewer files than
    ranks, callers should fall back to batch striding (stride_batches)."""
    paths = list(paths)
    if process_count <= 1 or len(paths) < process_count:
        return paths
    return paths[process_index::process_count]


def stride_batches(batches, process_index: int, process_count: int):
    """Every rank parses the shared stream but keeps batch i where
    i % process_count == process_index (parsing runs far above a card's
    align rate, so redundant parsing does not bound scaling until many
    ranks; beyond that, split the input into per-rank files). Each kept
    batch is tagged with its GLOBAL stream index — the ambiguous-read
    merge sorts spill rows back into single-process stream order with
    it."""
    for i, b in enumerate(batches):
        if i % process_count == process_index:
            try:
                b.global_index = i
            except AttributeError:   # non-batch items (unit tests)
                pass
            yield b


def _gather(x: np.ndarray) -> np.ndarray:
    """[P, ...]: every rank's equal-shape array, rank-major."""
    t = torch.from_numpy(np.ascontiguousarray(x))
    out = [torch.empty_like(t) for _ in range(process_count())]
    dist.all_gather(out, t)
    return torch.stack(out).numpy()


def _allgather_sum(x: np.ndarray) -> np.ndarray:
    """Elementwise sum of one per-rank array across all ranks, in the
    dtype np.sum gives over a rank axis (int32 -> int64). Integer sums
    are exact in any order: one all_reduce in that dtype. Float sums
    add the gathered arrays in rank order, as midas_tpu does."""
    x = np.asarray(x)
    out_dtype = np.zeros((1,) + x.shape, x.dtype).sum(axis=0).dtype
    if out_dtype == np.int64:
        t = torch.from_numpy(np.array(x, dtype=np.int64))
        dist.all_reduce(t)
        return t.numpy()
    return _gather(x).sum(axis=0)


def _allgather_rows(rows: np.ndarray) -> np.ndarray:
    """Concatenate per-rank row blocks rank-major (rank 0's rows first),
    padding ragged counts — the cross-rank twin of the spill buffers'
    stream-order append. Ranks with no rows take part all the same."""
    rows = np.asarray(rows)
    n = rows.shape[0]
    counts = _gather(np.array([n], dtype=np.int64))[:, 0]
    pad = np.zeros((max(int(counts.max()), 1),) + rows.shape[1:],
                   dtype=rows.dtype)
    pad[:n] = rows
    g = _gather(pad)
    return np.concatenate([g[p, : int(counts[p])]
                           for p in range(len(counts))])


def _allreduce_max(v: int) -> int:
    t = torch.tensor([v], dtype=torch.int64)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return int(t[0])


def merge_species_accumulators(
    unique_count: np.ndarray, unique_bp: np.ndarray,
    ambiguous: List, stats: Dict[str, int],
):
    """Cross-rank merge of one rank's species-classifier results; a
    single-process run short-circuits to the inputs. Counts, bp and
    stats are summed. Each ambiguous row (seq ids, species ids, aln bp,
    global stream rank) is gathered rank-major, its float64 bp exactly;
    the RNG assignment (SpeciesProfiler.assign_and_normalize) sorts the
    merged rows back into single-process stream order by the 4th
    element, so the sequential draws land on the same reads as a
    single-process run (reference draw order:
    midas/run/species.py:104-119)."""
    if process_count() == 1:
        return unique_count, unique_bp, ambiguous, stats

    g_count = _allgather_sum(unique_count)
    g_bp = _allgather_sum(unique_bp)
    # this rank's (seq, species, aln, ord) rows as padded arrays
    n = len(ambiguous)
    w = _allreduce_max(max([len(t[1]) for t in ambiguous], default=1))
    sp = np.full((n, w), -1, dtype=np.int64)
    bp = np.zeros((n, w), dtype=np.float64)
    sq = np.zeros((n, w), dtype=np.int64)
    od = np.zeros(n, dtype=np.int64)
    for r, t in enumerate(ambiguous):
        q, s, a = t[0], t[1], t[2]
        sq[r, : len(q)] = q
        sp[r, : len(s)] = s
        bp[r, : len(a)] = a
        od[r] = t[3] if len(t) > 3 else r
    g_sp, g_abp = _allgather_rows(sp), _allgather_rows(bp)
    g_sq, g_od = _allgather_rows(sq), _allgather_rows(od)
    merged = []
    for r in range(g_sp.shape[0]):
        cols = np.flatnonzero(g_sp[r] >= 0)
        merged.append((g_sq[r, cols], g_sp[r, cols], g_abp[r, cols],
                       int(g_od[r])))
    keys = list(stats)
    sums = _allgather_sum(np.array([stats[k] for k in keys], np.int64))
    g_stats = {k: int(v) for k, v in zip(keys, sums)}
    return g_count, g_bp, merged, g_stats


def merge_snps_accumulators(host: Dict[str, np.ndarray]
                            ) -> Dict[str, np.ndarray]:
    """Cross-rank merge of one rank's snps host state (SnpsProfiler.
    _accumulate's); a single-process run short-circuits to it. The
    flat [4 x (G+1)] counts and the per-species counters are summed
    (int32 -> int64); the gapped-read spill rows concatenate
    rank-major."""
    if process_count() == 1:
        return host
    merged = dict(
        counts=_allgather_sum(host["counts"]),
        aligned_reads=_allgather_sum(host["aligned_reads"]),
        mapped_reads=_allgather_sum(host["mapped_reads"]),
        gap_codes=_allgather_rows(host["gap_codes"]),
        gap_quals=_allgather_rows(host["gap_quals"]),
        gap_meta=_allgather_rows(host["gap_meta"]),
    )
    merged["gap_n"] = np.int64(merged["gap_codes"].shape[0])
    return merged


def _barrier() -> None:
    """Barrier AFTER rank 0 writes outputs: without it a later pipeline
    stage on another rank can race the write on a shared filesystem
    (read a missing or torn species profile) while rank 0 still writes."""
    if process_count() > 1:
        dist.barrier()


def _make_local_profiler(cls_single, cls_dist, db, species_ids, tp, kw):
    """This rank's profiler: on its one card, or with tp > 1 over tp
    shards of the pack and index (dist/sharded.py::shard_devices)."""
    if tp > 1:
        return cls_dist(db, species_ids, tp=tp, **kw)
    return cls_single(db, species_ids, **kw)


def _stride_setup(prof, read_paths, pid, pcount, paired: bool = False,
                  max_reads=None, force_stride: bool = False):
    """Pick the per-rank input sharding. File-granular sharding is only
    safe when the run is unpaired, uncapped, and has at least one file
    per rank: paired inputs must never split (m1, m2) across ranks
    (each rank would then mispair consecutive reads of ONE mate file),
    and max_reads must cap the SHARED stream before striding (per-file
    caps would process up to pcount*max_reads reads and diverge from a
    single-process run). Everything else batch-strides the shared
    stream. force_stride skips file sharding entirely — species runs
    need every batch's GLOBAL stream index for the ambiguous-read
    stream-order merge, and with whole files per rank batches do not
    align to any shared stream. Striding also records (pid, pcount) in
    prof._stride, which the species checkpoint's fingerprint includes,
    so a rerun with another rank count never resumes a rank's state."""
    if (pcount > 1 and not paired and max_reads is None and not force_stride
            and len(read_paths) >= pcount):
        return shard_read_paths(read_paths, pid, pcount)
    if pcount > 1:
        prof._batch_filter = lambda bs: stride_batches(bs, pid, pcount)
        prof._stride = (pid, pcount)
    return list(read_paths)


def _database(db):
    from midas_tpu_torch.db.layout import Database

    return db if isinstance(db, Database) else Database(db)


def run_genes_multihost(
    db, read_paths, species_ids, outdir: Optional[str] = None,
    tp: int = 1, batch_size: int = 8192, max_reads: Optional[int] = None,
    trim: int = 0, paired: bool = False, interleaved: bool = False,
    read_length: Optional[int] = None, device="cuda",
    **profiler_kw,
) -> Dict:
    """Multi-process CNV profiling: every rank streams a disjoint shard
    of the reads on its card, then the small [G+1] aligned/mapped/bp
    accumulators merge with one end-of-stream sum (the cross-process
    analogue of the reference's fork-pool reduction,
    midas/utility.py:81-107) — no per-batch traffic. Every rank computes
    the same results; rank 0 writes genes/output/*.genes.gz +
    summary.txt when outdir is given."""
    from midas_tpu_torch.dist.profilers import DistributedGenesProfiler
    from midas_tpu_torch.profile.genes import GenesProfiler

    db = _database(db)
    pid, pcount = process_index(), process_count()
    if isinstance(read_paths, str):
        read_paths = [read_paths]
    prof = _make_local_profiler(GenesProfiler, DistributedGenesProfiler, db,
                                species_ids, tp,
                                dict(profiler_kw, device=device))
    my_paths = _stride_setup(prof, read_paths, pid, pcount,
                             paired=paired, max_reads=max_reads)
    host = prof._accumulate(my_paths, max_reads, trim, batch_size,
                            paired=paired, interleaved=interleaved,
                            read_length=read_length)
    if pcount > 1:
        host = {k: _allgather_sum(v) for k, v in host.items()}
    results = prof._finalize(host)
    if outdir is not None and pid == 0:
        prof.write_results(outdir)
    _barrier()
    return results


def run_snps_multihost(
    db, read_paths, species_ids, outdir: Optional[str] = None,
    tp: int = 1, batch_size: int = 8192, max_reads: Optional[int] = None,
    trim: int = 0, paired: bool = False, interleaved: bool = False,
    read_length: Optional[int] = None, device="cuda",
    **profiler_kw,
) -> Dict:
    """Multi-process SNP pileup: ranks stream disjoint read shards; at
    the end of the stream the dense [4 x (G+1)] counts and per-species
    counters merge with a sum and the rare gapped-read spill rows
    concatenate rank-major (the pileup's adds commute, so row order only
    needs to be deterministic). Matches the reference's line-range shard
    merge (midas/merge/snps.py:366-386) with collectives instead of temp
    files. Rank 0 writes snps/output/*.snps.gz + summary.txt."""
    from midas_tpu_torch.dist.profilers import DistributedSnpsProfiler
    from midas_tpu_torch.profile.snps import SnpsProfiler

    db = _database(db)
    pid, pcount = process_index(), process_count()
    if isinstance(read_paths, str):
        read_paths = [read_paths]
    prof = _make_local_profiler(SnpsProfiler, DistributedSnpsProfiler, db,
                                species_ids, tp,
                                dict(profiler_kw, device=device))
    my_paths = _stride_setup(prof, read_paths, pid, pcount,
                             paired=paired, max_reads=max_reads)
    host = prof._accumulate(my_paths, max_reads, trim, batch_size,
                            paired=paired, interleaved=interleaved,
                            read_length=read_length)
    results = prof._finalize(merge_snps_accumulators(host))
    if outdir is not None and pid == 0:
        prof.write_results(outdir)
    _barrier()
    return results


def run_species_multihost(
    db, read_paths, outdir: Optional[str] = None,
    tp: int = 1, batch_size: int = 8192,
    read_length: Optional[int] = None, max_reads: Optional[int] = None,
    seed: int = 42, checkpoint_path: Optional[str] = None, device="cuda",
    **profiler_kw,
) -> Dict:
    """Species profile over every rank's card; returns the abundance
    dict (identical on all ranks). Rank 0 writes species_profile.txt and
    temp/read_count.txt when outdir is given. checkpoint_path is this
    rank's own state file (run_species: temp/state.rank{pid}.npz)."""
    from midas_tpu_torch.dist.species import DistributedSpeciesProfiler
    from midas_tpu_torch.profile.species import SpeciesProfiler, write_abundance

    db = _database(db)
    pid, pcount = process_index(), process_count()
    if isinstance(read_paths, str):
        read_paths = [read_paths]
    if tp > 1:
        prof = DistributedSpeciesProfiler(db, tp=tp, seed=seed,
                                          device=device, **profiler_kw)
    else:
        prof = SpeciesProfiler(db, seed=seed, device=device, **profiler_kw)
    my_paths = _stride_setup(prof, read_paths, pid, pcount,
                             max_reads=max_reads, force_stride=True)

    unique_count, unique_bp, ambiguous = prof._run_device(
        my_paths, read_length, max_reads, batch_size,
        checkpoint_path=checkpoint_path)
    unique_count, unique_bp, ambiguous, prof.stats = (
        merge_species_accumulators(unique_count, unique_bp, ambiguous,
                                   prof.stats))
    abundance = prof.assign_and_normalize(unique_count, unique_bp, ambiguous)
    if outdir is not None and pid == 0:
        os.makedirs(os.path.join(outdir, "species/temp"), exist_ok=True)
        write_abundance(
            os.path.join(outdir, "species/species_profile.txt"), abundance)
        with open(os.path.join(outdir, "species/temp/read_count.txt"),
                  "w") as f:
            f.write(f"{prof.stats['total_reads']}\t"
                    f"{prof.stats['total_bp']}")
    _barrier()
    return abundance
