"""The benchmark of ``kcftools_tpu_torch``: ``python3 portbench/run.py``."""
