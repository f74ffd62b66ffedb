"""Benchmarks of the port that run on the GPU (counterparts of
``benchmarks/``): ``fig5_microbench`` so far."""
