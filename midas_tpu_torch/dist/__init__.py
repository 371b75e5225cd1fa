"""Multi-process runs of the per-sample pipelines on torch.distributed,
one rank per card set (dist/driver.py), and tensor parallelism: the
pack and seed index sharded across devices (dist/sharded.py,
dist/species.py, dist/profilers.py)."""
from midas_tpu_torch.dist.sharded import (
    distributed_profile_step,
    shard_devices,
    shard_index,
)
