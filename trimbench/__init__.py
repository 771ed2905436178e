"""trimbench: the benchmark of mvtrim_tpu_torch on an NVIDIA H100.

``python -m trimbench --workload <name> --seed <n> --seconds <s> --trace
<0|1>`` runs one cell once (see ``README.md``).  Nothing here imports JAX
or the JAX package; ``reference/`` imports nothing of the program either.
"""
