"""Torch twins of the JAX package's ``benchmarks/`` modules: each drives
the port's entry points and prints ``benchmarks/run.py``'s CSV
(``name,us_per_call,derived``); none writes a ``BENCH_*.json``."""
