"""midas_tpu_torch — the PyTorch/CUDA port of midas_tpu.

A second package beside the JAX one, with the same module layout so each
module's counterpart is found by name. It imports torch and numpy, never
JAX and nothing of midas_tpu; the modules it needs from there are copied.
The banded-DP kernel is written by hand in CUDA for Hopper
(csrc/banded_sw.cu) and built on first use into build/.

Entry points (profile.species.SpeciesProfiler, run_species, the
cli.run_midas CLI) run on the card by default (device="cuda") and raise
without one; they run on the CPU, with the plain PyTorch versions of the
kernels, only when the caller passes device="cpu".

Ported: `run_midas species|genes|snps` (reads single-end or
mate-paired; species with --m8) and `merge_midas`, on one device, over
several processes, one rank per card (dist/driver.py), or with the index
in tensor-parallel shards (dist/sharded.py); the analysis tools
(cli/analysis.py), `split_reads` and `build_midas_db` (cli/build_db.py),
host numpy like midas_tpu's; and the end-of-stream pileup readback
(profile/sparse_counts.py: the sparse route or the whole int32 copy, by
the card host's measured costs; midas_tpu's tiered counts_host and
async snapshot are left out, no faster on the H100).
"""

__version__ = "0.1.0"
