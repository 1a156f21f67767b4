"""Extended Koopmans' theorem generalized Fock matrices.

Batched counterpart of ``pauxy/estimators/ekt.py:10-90``: 1-particle and
1-hole generalized Fock matrices built from Cholesky vectors and (spin) one
particle RDMs, batched over walkers so they can accumulate inside the
back-propagation measurement. The reference's per-Cholesky python loop
(``ekt.py:31-37, 66-71``) is one einsum chain.

Conventions: chol[p, q, x] (package layout; the reference uses [x, p, q]),
RDMs P_s[w, p, q] = <c_p^dag c_q>.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def ekt_1p_fock(h1: jax.Array, chol: jax.Array, p_a: jax.Array, p_b: jax.Array):
    """1-particle (electron-attachment) generalized Fock, [w, M, M].

    Reference: ``ekt.py:10-42`` (ekt_1p_fock_opt).
    """
    m = h1.shape[-1]
    eye = jnp.eye(m, dtype=p_a.dtype)
    gamma = 2 * eye - jnp.swapaxes(p_a, -1, -2) - jnp.swapaxes(p_b, -1, -2)
    rdm1 = p_a + p_b

    xa = jnp.einsum("pqx,wpq->wx", chol, p_a, optimize=True)
    xb = jnp.einsum("pqx,wpq->wx", chol, p_b, optimize=True)
    # Xchol[w, q, p] = sum_x X[w, x] chol[p, q, x]  (transpose(0,2,1) of ref)
    xachol = jnp.einsum("wx,pqx->wqp", xa, chol, optimize=True)
    xbchol = jnp.einsum("wx,pqx->wqp", xb, chol, optimize=True)

    pat = jnp.swapaxes(p_a, -1, -2)
    pbt = jnp.swapaxes(p_b, -1, -2)
    j = (
        2.0 * (xachol + xbchol)
        - 2.0 * jnp.einsum("wpq,wqr->wpr", pat, xbchol, optimize=True)
        - jnp.einsum("wpq,wqr->wpr", pat, xachol, optimize=True)
        - jnp.einsum("wpq,wqr->wpr", pbt, xbchol, optimize=True)
    )
    # K = sum_x [- c P^T c^T + Pa^T c Pa^T c^T + Pb^T c Pb^T c^T], with
    # c = chol[:, :, x] and c2 = c^T (ekt.py:31-37).
    rt = jnp.swapaxes(rdm1, -1, -2)
    k = -jnp.einsum("pax,wab,qbx->wpq", chol, rt, chol, optimize=True)
    k = k + jnp.einsum(
        "wpa,abx,wbc,qcx->wpq", pat, chol, pat, chol, optimize=True
    )
    k = k + jnp.einsum(
        "wpa,abx,wbc,qcx->wpq", pbt, chol, pbt, chol, optimize=True
    )
    return jnp.einsum("wpq,qr->wpr", gamma, h1, optimize=True) + j + k


def ekt_1h_fock(h1: jax.Array, chol: jax.Array, p_a: jax.Array, p_b: jax.Array):
    """1-hole (ionization) generalized Fock, [w, M, M].

    Reference: ``ekt.py:46-76`` (ekt_1h_fock_opt).
    """
    xa = jnp.einsum("pqx,wpq->wx", chol, p_a, optimize=True)
    xb = jnp.einsum("pqx,wpq->wx", chol, p_b, optimize=True)
    xachol = jnp.einsum("wx,pqx->wqp", xa, chol, optimize=True)
    xbchol = jnp.einsum("wx,pqx->wqp", xb, chol, optimize=True)

    j = (
        -2.0 * jnp.einsum("wpa,wqa->wpq", p_a, xbchol, optimize=True)
        - jnp.einsum("wpa,wqa->wpq", p_a, xachol, optimize=True)
        - jnp.einsum("wpa,wqa->wpq", p_b, xbchol, optimize=True)
    )
    # K = Pa c^T Pa c2^T + Pa c^T Pb c2^T with c2^T = c (ekt.py:66-71).
    k = jnp.einsum(
        "wpa,bax,wbc,cqx->wpq", p_a, chol, p_a, chol, optimize=True
    )
    k = k + jnp.einsum(
        "wpa,bax,wbc,cqx->wpq", p_a, chol, p_b, chol, optimize=True
    )
    gamma = p_a + p_b
    return -jnp.einsum("wpa,qa->wpq", gamma, h1, optimize=True) + j + k
