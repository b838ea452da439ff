"""The benchmark of pymbar_tpu_torch (see portbench/README.md)."""
