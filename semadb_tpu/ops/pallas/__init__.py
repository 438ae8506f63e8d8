"""Pallas kernels for the GPU (Triton route), each with a plain XLA
reference in ``semadb_tpu.ops``."""
