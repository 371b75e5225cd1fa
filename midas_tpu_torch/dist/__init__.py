"""Multi-process runs of the per-sample pipelines on torch.distributed,
one rank per card (dist/driver.py). Sharding the seed index across cards
(tensor parallelism) is not ported."""
