"""Host->device input pipeline: parse + upload overlapped with compute.

The reference overlaps stages with unix pipes between processes
(stream_seqs | hs-blastn, midas/run/species.py:29-49). Here a producer
thread parses FASTQ batches, copies them into pinned host tensors and
uploads them with non_blocking copies on a side CUDA stream, while the
consumer's previous batch still runs on the card — bounded by a small
queue. Each upload records an event; the consumer's stream waits on it
before the batch is used, and the tensors are record_stream'ed to the
consumer's stream so the caching allocator does not reuse their memory
while work queued there may still read them. On the CPU the batches are
handed over as tensors, no copy.

Spans (tracing.py): io.parse around each next() of the batch stream and
io.upload around each upload, on the producer thread under the
consumer's span; io.put_wait while the producer waits on a full queue;
io.wait around the consumer's get. Counters: io.batches, io.reads.
"""

from __future__ import annotations

import itertools
import queue
import threading
from typing import Iterator, Sequence

import numpy as np
import torch

from midas_tpu_torch import tracing


class DeviceBatch:
    """One uploaded batch: device tensors + the host-side bookkeeping the
    profilers need (counts for totals; names stay host-only).

    index is the batch's position in THIS consumer's stream (checkpoint
    bookkeeping counts consumed batches); global_index is its position
    in the SHARED single-process stream — they differ only under
    multi-host batch striding, and it keys the ambiguous-read
    stream-order merge."""

    __slots__ = ("n_reads", "total_bp", "arrays", "index", "global_index")

    def __init__(self, n_reads: int, total_bp: int, arrays: tuple, index: int,
                 global_index: int = None):
        self.n_reads = n_reads
        self.total_bp = total_bp
        self.arrays = arrays
        self.index = index
        self.global_index = index if global_index is None else global_index


def trim_batch(batch, trim: int) -> None:
    """Drop `trim` bases from the 3' end of every read of a ReadBatch, in
    place. The readq filter's mean quality is over the read as aligned
    (the reference's np.mean(aln.query_qualities) after --trim3,
    midas/run/genes.py:122,160), so the trimmed bases' qualities leave
    the mean; the quality plane itself is kept as parsed."""
    batch.lengths = np.maximum(batch.lengths - trim, 0).astype(np.int32)
    L = batch.codes.shape[1]
    keep = np.arange(L)[None, :] < batch.lengths[:, None]
    batch.codes[~keep] = 4
    qs = np.where(keep, batch.quals, 0).astype(np.float64)
    n = np.maximum(batch.lengths, 1).astype(np.float64)
    batch.mean_qual = (qs.sum(axis=1) / n).astype(np.float32)


def prefetch_device_batches(
    batches: Iterator,
    fields: Sequence[str] = ("codes", "lengths"),
    device="cuda",
    prefetch: int = 3,
    skip_batches: int = 0,
    trim: int = 0,
) -> Iterator[DeviceBatch]:
    """Parse + upload in a background thread, `prefetch` batches deep.

    fields: ReadBatch attributes to upload, in order (e.g. ("codes",
    "quals", "lengths", "mean_qual")); DeviceBatch.arrays holds them as
    tensors on `device`. skip_batches parses and discards the
    first k batches without uploading (checkpoint resume: the stream is
    deterministic, so batch k+1 onward reproduce the original run).
    trim applies the reference's --trim3 semantics (genes.py:122) before
    upload (trim_batch).

    Exceptions in the producer re-raise in the consumer. If the consumer
    abandons the generator early, the producer notices via a stop flag
    and terminates instead of blocking forever on a full queue."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    if cuda and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    side = torch.cuda.Stream(device) if cuda else None
    q: queue.Queue = queue.Queue(maxsize=max(prefetch, 1))
    END = object()
    stop = threading.Event()

    def _put(item) -> bool:
        if stop.is_set():
            return False
        try:
            q.put_nowait(item)
            return True
        except queue.Full:
            pass
        with tracing.span("io.put_wait"):
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
        return False

    def upload(batch):
        with tracing.span("io.upload"):
            host = [torch.from_numpy(np.ascontiguousarray(getattr(batch, f)))
                    for f in fields]
            if not cuda:
                return tuple(host), None
            with torch.cuda.stream(side):
                arrays = tuple(h.pin_memory().to(device, non_blocking=True)
                               for h in host)
                done = torch.cuda.Event()
                done.record(side)
            return arrays, done

    def produce(parent):
        with tracing.under(parent):
            try:
                stream = iter(batches)
                for bi in itertools.count():
                    with tracing.span("io.parse"):
                        batch = next(stream, END)
                    if batch is END or stop.is_set():
                        break
                    if bi < skip_batches:
                        continue
                    if trim:
                        trim_batch(batch, trim)
                    arrays, done = upload(batch)
                    total_bp = int(batch.lengths[: batch.n_reads].sum())
                    db = DeviceBatch(batch.n_reads, total_bp, arrays, bi,
                                     getattr(batch, "global_index", bi))
                    tracing.count("io.batches", 1)
                    tracing.count("io.reads", batch.n_reads)
                    if not _put((db, done)):
                        return
                _put(END)
            except BaseException as e:  # noqa: BLE001 - re-raised in consumer
                _put(e)

    t = threading.Thread(target=produce, args=(tracing.current(),),
                         daemon=True)
    t.start()
    try:
        while True:
            with tracing.span("io.wait"):
                item = q.get()
            if item is END:
                break
            if isinstance(item, BaseException):
                raise item
            db, done = item
            if done is not None:
                consumer = torch.cuda.current_stream(device)
                consumer.wait_event(done)
                for a in db.arrays:
                    a.record_stream(consumer)
            yield db
    finally:
        stop.set()
        t.join(timeout=5.0)
