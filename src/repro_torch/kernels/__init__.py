"""Bit-packed block-sparse SpMM for the port: host packing, the CUDA
kernels (sources in ``csrc/``), their wrappers and plain versions."""
