"""Batched Slater-determinant overlap and Green's function kernels.

Batched rewrite of the per-walker linear algebra in the reference:
``pauxy/walkers/single_det.py:295-321`` (greens_function),
``single_det.py:170-199`` (calc_overlap), ``single_det.py:215-255`` (reortho)
and ``pauxy/estimators/greens_function.py:5-115`` (gab / gab_mod).

Conventions
-----------
* ``phi``  : walker Slater matrices, shape ``[w, M, n]`` (one spin sector).
* ``psi``  : trial Slater matrix, shape ``[M, n]``.
* Overlaps are kept in log space: ``log_ovlp = log|det S| + i arg(det S)``
  with ``S = phi^T conj(psi)``; this replaces the reference's ad-hoc
  ``log_shift`` over/underflow bookkeeping.
* The full Green's function is ``G = conj(psi) (phi^T conj(psi))^{-1} phi^T``
  (``[w, M, M]``) and the half-rotated one is
  ``Ghalf = (phi^T conj(psi))^{-1} phi^T`` (``[w, n, M]``), matching
  ``single_det.py:310-319``.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from pauxy_jax.ops import clinalg


class SpinGreens(NamedTuple):
    """Green's function bundle for one spin sector (batched over walkers).

    For multi-determinant trials ``Ghalf`` carries a determinant axis
    ([w, D, n, M]) and ``det_weights`` the per-walker overlap weights
    w_d = conj(c_d) det_d / sum_d' (None for single determinants).
    """

    G: jax.Array        # [w, M, M] full Green's function
    Ghalf: jax.Array    # [w, n, M] half-rotated Green's function
    log_ovlp: jax.Array  # [w] complex log of det(phi^T conj(psi))
    det_weights: jax.Array = None  # [w, D] for MSD trials


def _clog_det(sign: jax.Array, logdet: jax.Array, cdtype) -> jax.Array:
    """Combine slogdet output into a complex log-determinant."""
    sign = sign.astype(cdtype)
    # log(sign) = i*arg(sign); sign has unit magnitude.
    return logdet.astype(cdtype) + jnp.log(sign)


def overlap_matrix(phi: jax.Array, psi: jax.Array) -> jax.Array:
    """S = phi^T conj(psi), shape [w, n, n]  (single_det.py:310)."""
    return jnp.einsum("wmi,mj->wij", phi, psi.conj(), optimize=True)


def log_overlap(phi: jax.Array, psi: jax.Array) -> jax.Array:
    """Batched complex log overlap log det(phi^T conj(psi)), shape [w].

    Reference: ``single_det.py:170-199`` (calc_overlap), done in log space.
    """
    s = overlap_matrix(phi, psi)
    return clinalg.slogdet(s).astype(phi.dtype)


def greens_function(phi: jax.Array, psi: jax.Array) -> SpinGreens:
    """Batched walker Green's function for one spin sector.

    Returns G, Ghalf and the complex log overlap. One LU factorization per
    walker (n x n, tiny); the heavy work is the two [w,M,n]x[n,M] batched
    matmuls.

    Reference: ``single_det.py:295-321``.
    """
    s = overlap_matrix(phi, psi)                          # [w, n, n]
    log_det = clinalg.slogdet(s).astype(phi.dtype)
    # Ghalf = S^{-1} phi^T : solve instead of explicit inverse.
    ghalf = clinalg.solve(s, jnp.swapaxes(phi, -1, -2))  # [w, n, M]
    g = jnp.einsum("mi,win->wmn", psi.conj(), ghalf, optimize=True)
    return SpinGreens(G=g, Ghalf=ghalf, log_ovlp=log_det)


def gab(a: jax.Array, b: jax.Array) -> jax.Array:
    """One-particle Green's function between two (batched) determinants.

    G = B (A^dagger B)^{-1} A^dagger  with a/b of shape [..., M, n].
    Reference: ``pauxy/estimators/greens_function.py:5-38``.
    """
    adag = jnp.swapaxes(a.conj(), -1, -2)                 # [..., n, M]
    return b @ clinalg.solve(adag @ b, adag)              # [..., M, M]


def reortho(phi: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Batched re-orthogonalisation of walker Slater matrices.

    Returns the orthonormalised ``phi`` and ``log_detR`` (real, [w]), with
    det(R) real positive by construction.

    Reference: ``single_det.py:215-255`` uses LAPACK QR + explicit sign
    fixing of diag(R); here CholeskyQR2 gives the same contract (same
    column span, positive diag(R)) out of two matmul passes —
    see ops/clinalg.py.
    """
    return clinalg.cholesky_qr2(phi)
