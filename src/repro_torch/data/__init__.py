"""Deterministic synthetic data, federated partitions and batch iteration
(numpy, copied from the JAX package so the port imports none of it)."""
