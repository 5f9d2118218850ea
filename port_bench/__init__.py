"""The benchmark of the PyTorch/CUDA port (``quad_periodic_mpc_tpu_torch``).

``python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once on a CUDA card
and prints one JSON line last.  See ``run.py``."""
