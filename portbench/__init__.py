"""The benchmark of the PyTorch/CUDA port (``umetrack_torch``) on an H100.

``python -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace
<0|1>`` runs one cell once; see ``portbench/README.md``.  The benchmark
never imports the JAX package, and its reference (``portbench/reference/``)
never imports the program.
"""
