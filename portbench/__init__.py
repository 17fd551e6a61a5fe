"""The benchmark of ``autoforce_tpu_torch`` on an NVIDIA H100.

``python3 -m portbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell once and prints one JSON line.  Nothing here
imports JAX or the JAX package; ``portbench.reference`` imports nothing of
the port either.
"""
