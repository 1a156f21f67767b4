"""QMC drivers and options."""

from pauxy_jax.qmc.options import QMCOpts
from pauxy_jax.qmc.afqmc import AFQMC

__all__ = ["QMCOpts", "AFQMC"]
