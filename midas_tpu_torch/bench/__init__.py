"""Benchmarks of the port on the card: the counterparts of the JAX
package's bench.py (`python -m midas_tpu_torch.bench`), bench_scale.py
(`python -m midas_tpu_torch.bench.scale`) and bench_marker_budget.py
(`python -m midas_tpu_torch.bench.budget`). Each prints one JSON line
and runs on the card unless asked for the CPU."""
