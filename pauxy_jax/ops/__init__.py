"""Batched compute kernels (the hot path).

Everything in here operates on arrays with a leading walker axis ``w`` and is
designed to be traced once under ``jax.jit`` — static shapes, no Python
control flow on traced values, matmul-dominated so XLA can hand the work to GEMMs.
"""
