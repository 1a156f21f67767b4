"""Imaginary-time propagation (zero temperature)."""

from pauxy_jax.propagation.continuous import (
    Continuous,
    propagate_phaseless,
    propagate_free,
)

__all__ = ["Continuous", "propagate_phaseless", "propagate_free"]
