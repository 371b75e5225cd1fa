from midas_tpu_torch.io.seqio import (
    iopen,
    parse_file,
    read_fastx,
    stream_reads,
    encode_seq,
    decode_seq,
    revcomp_codes,
    BASE_TO_CODE,
    CODE_TO_BASE,
)
from midas_tpu_torch.io.batch import ReadBatch, batch_reads, load_read_batches
