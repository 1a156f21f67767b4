"""pauxy-jax: an auxiliary-field quantum Monte Carlo framework in JAX.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of pauxy
(github.com/pauxy-qmc/pauxy): phaseless / constrained-path / free-projection
AFQMC for model (Hubbard, UEG, Hubbard-Holstein) and ab-initio (Cholesky
factorized) fermionic Hamiltonians, at zero and finite temperature.

Design (vs. the reference's per-walker Python objects + MPI):

* Walkers are a single struct-of-arrays pytree with a leading walker axis;
  per-walker loops become ``vmap``-style batched linear algebra.
* One QMC step is a pure function ``(state, key) -> state`` executed under
  ``jax.lax.scan`` inside a single jitted program per block.
* Population control is a deterministic gather by parent index on dense,
  fixed-shape arrays (no ragged sends).
* Multi-chip execution shards the walker axis over a ``jax.sharding.Mesh``;
  MPI collectives of the reference map onto XLA collectives.
"""

__version__ = "0.1.0"

from pauxy_jax import config

__all__ = ["config", "__version__"]
