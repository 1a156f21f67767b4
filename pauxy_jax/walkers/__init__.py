"""Batched walker state and population control."""

from pauxy_jax.walkers.state import WalkerState, init_walkers

__all__ = ["WalkerState", "init_walkers"]
