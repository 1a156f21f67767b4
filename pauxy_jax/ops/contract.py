"""Mixed real/complex contractions.

Ab-initio Cholesky tensors (and their half-rotations) are REAL for
molecular Hamiltonians — only k-point / twisted Hamiltonians make them
complex. Contracting a real weight tensor against complex walker data as a
plain ``jnp.einsum`` first promotes the real operand to complex, doubling
both the matmul work (4 real matmuls instead of 2) and the weight-tensor
HBM traffic. ``cr_einsum`` keeps the weight real: one real einsum against
each of the complex operand's parts.

Storage policy: ``models/generic.make_generic`` and the trial half-rotation
keep chol/rchol at their natural dtype (real unless genuinely complex);
every hot contraction routes through here. A missed site stays correct —
einsum's automatic promotion — just slower.
"""

from __future__ import annotations

import jax.numpy as jnp


def cr_einsum(eq: str, w, z, **kwargs):
    """einsum(eq, w, z) where ``w`` may be real while ``z`` is complex.

    Real w: two real einsums (against z.real / z.imag) recombined — half
    the matmul work of the promoted complex path. Complex w or real z: plain
    einsum.
    """
    if jnp.iscomplexobj(w) or not jnp.iscomplexobj(z):
        return jnp.einsum(eq, w, z, **kwargs)
    return (
        jnp.einsum(eq, w, z.real, **kwargs)
        + 1j * jnp.einsum(eq, w, z.imag, **kwargs)
    )


def rc_einsum(eq: str, z, w, **kwargs):
    """einsum(eq, z, w) with the possibly-real weight SECOND."""
    if jnp.iscomplexobj(w) or not jnp.iscomplexobj(z):
        return jnp.einsum(eq, z, w, **kwargs)
    return (
        jnp.einsum(eq, z.real, w, **kwargs)
        + 1j * jnp.einsum(eq, z.imag, w, **kwargs)
    )