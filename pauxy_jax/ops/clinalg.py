"""Complex linear algebra built from real decompositions + matmuls.

AFQMC is irreducibly complex-valued (overlaps carry a phase that the
phaseless constraint projects on). The three hot decompositions are built
here from real factorizations and matmuls:

* :func:`solve`    — complex solve via the real 2n block embedding
  iota(A+iB) = [[A, -B], [B, A]] (iota is a ring homomorphism, so
  iota(S)^-1 iota(Y) = iota(S^-1 Y)).
* :func:`cholesky` / :func:`cholesky_qr` — complex Cholesky via the
  *interleaved* embedding (real/imag per index), under which the embedding
  of a lower-triangular complex matrix with real diagonal IS real
  lower-triangular, so chol(embed(S)) = embed(chol(S)) by uniqueness.
  CholeskyQR2 replaces LAPACK QR for walker re-orthogonalisation: two matmul
  passes + tiny Cholesky, with det(R) = prod diag(L1) diag(L2) real
  positive by construction — exactly the detR > 0 convention the reference
  enforces by sign-fixing (``pauxy/walkers/single_det.py:234-242``).
* :func:`slogdet`  — complex log-determinant WITH phase via a batched
  Gaussian-elimination scan with partial pivoting (n = number of electrons
  is tiny; n sequential rank-1 updates, vectorized over walkers).

The same code runs on every backend and is validated against numpy in
tests/test_clinalg.py.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _real_dtype(cdtype):
    return jnp.zeros((), cdtype).real.dtype


# ----------------------------------------------------------------------------
# Block embeddings
# ----------------------------------------------------------------------------

def _embed_block(s: jax.Array) -> jax.Array:
    """[..., n, n] complex -> [..., 2n, 2n] real, [[A, -B], [B, A]]."""
    a, b = s.real, s.imag
    top = jnp.concatenate([a, -b], axis=-1)
    bot = jnp.concatenate([b, a], axis=-1)
    return jnp.concatenate([top, bot], axis=-2)


def solve(s: jax.Array, y: jax.Array) -> jax.Array:
    """Batched complex solve S X = Y.

    s: [..., n, n] complex, y: [..., n, m] complex: LU on the real 2n
    block embedding.
    """
    # The solution dtype follows BOTH operands: a real S with a complex Y
    # has a complex solution (casting to s.dtype would silently drop the
    # imaginary half).
    out_dtype = jnp.result_type(s.dtype, y.dtype)
    if s.shape[-1] == 0:
        # Empty system (fully spin-polarized 0-electron blocks).
        return y.astype(out_dtype)
    se = _embed_block(s)
    ye = jnp.concatenate([y.real, y.imag], axis=-2)       # [..., 2n, m]
    xe = jnp.linalg.solve(se, ye)
    n = s.shape[-1]
    return (xe[..., :n, :] + 1j * xe[..., n:, :]).astype(out_dtype)


def inv(s: jax.Array) -> jax.Array:
    """Batched explicit inverse of ``s [..., n, n]``: :func:`solve`
    against the identity."""
    eye = jnp.broadcast_to(jnp.eye(s.shape[-1], dtype=s.dtype), s.shape)
    return solve(s, eye)


def _interleave(s: jax.Array) -> jax.Array:
    """[..., n, n] complex -> [..., 2n, 2n] real with per-index 2x2 blocks
    [[a, -b], [b, a]] (the interleaved embedding)."""
    *batch, n, _ = s.shape
    a, b = s.real, s.imag
    # rows: stack (a_row, b_row) pairs; cols: stack (re, im) pairs.
    m = jnp.stack(
        [jnp.stack([a, -b], axis=-1), jnp.stack([b, a], axis=-1)], axis=-3
    )  # [..., n, 2, n, 2]
    return m.reshape(*batch, 2 * n, 2 * n)


def _deinterleave(m: jax.Array, cdtype) -> jax.Array:
    """Inverse of :func:`_interleave` (reads the (re, im) components)."""
    *batch, n2, _ = m.shape
    n = n2 // 2
    m = m.reshape(*batch, n, 2, n, 2)
    return (m[..., :, 0, :, 0] + 1j * m[..., :, 1, :, 0]).astype(cdtype)


def cholesky(s: jax.Array) -> jax.Array:
    """Batched Cholesky of a Hermitian positive-definite complex matrix.

    Returns lower-triangular L with real positive diagonal, S = L L^dagger.
    """
    le = jnp.linalg.cholesky(_interleave(s))
    return _deinterleave(le, s.dtype)


def triangular_solve_lower(l: jax.Array, y: jax.Array) -> jax.Array:
    """Solve L X = Y for lower-triangular complex L (batched)."""
    le = _interleave(l)
    *batch, n, m = y.shape
    ye = jnp.stack([y.real, y.imag], axis=-2).reshape(*batch, 2 * n, m)
    xe = jax.lax.linalg.triangular_solve(
        le, ye, left_side=True, lower=True
    )
    xe = xe.reshape(*batch, n, 2, m)
    return (xe[..., 0, :] + 1j * xe[..., 1, :]).astype(l.dtype)


# ----------------------------------------------------------------------------
# CholeskyQR2 orthogonalisation
# ----------------------------------------------------------------------------

def cholesky_qr(phi: jax.Array) -> tuple[jax.Array, jax.Array]:
    """One CholeskyQR pass: phi = Q R, Q orthonormal, diag(R) real positive.

    Returns (Q, log diag(R)) — the full R is never needed by AFQMC, only
    log det R = sum log diag.
    """
    if phi.shape[-1] == 0:
        # 0-column determinant blocks: Q empty, log det R = 0.
        return phi, jnp.zeros(phi.shape[:-2] + (1,), phi.real.dtype)
    s = jnp.einsum("...mi,...mj->...ij", phi.conj(), phi)
    l = cholesky(s)
    # Q = phi L^-dagger  <=>  L Q^dagger = phi^dagger.
    qd = triangular_solve_lower(l, jnp.swapaxes(phi.conj(), -1, -2))
    q = jnp.swapaxes(qd.conj(), -1, -2)
    diag = jnp.diagonal(l, axis1=-2, axis2=-1).real
    return q, jnp.log(diag)


def cholesky_qr2(phi: jax.Array) -> tuple[jax.Array, jax.Array]:
    """CholeskyQR2: two passes for f32-grade stability. Returns
    (Q, log_detR) with log_detR real, [batch]."""
    q, d1 = cholesky_qr(phi)
    q, d2 = cholesky_qr(q)
    return q, (d1 + d2).sum(-1)


# ----------------------------------------------------------------------------
# Complex slogdet with phase (batched Gaussian elimination, partial pivot)
# ----------------------------------------------------------------------------

def _slogdet_single(s: jax.Array) -> jax.Array:
    """Complex log det of one n x n matrix via pivoted elimination scan."""
    n = s.shape[-1]
    cdtype = s.dtype
    rows = jnp.arange(n)

    def body(k, carry):
        s, logdet, swaps = carry
        col = jnp.abs(s[:, k])
        col = jnp.where(rows >= k, col, -1.0)
        p = jnp.argmax(col)
        # Swap rows k and p.
        perm = jnp.where(rows == k, p, jnp.where(rows == p, k, rows))
        s = s[perm]
        swaps = swaps + (p != k)
        pivot = s[k, k]
        logdet = logdet + jnp.log(pivot)
        # Eliminate below the pivot (mask keeps shapes static).
        factor = jnp.where(rows > k, s[:, k] / pivot, 0.0).astype(cdtype)
        s = s - factor[:, None] * s[k][None, :]
        return s, logdet, swaps

    _, logdet, swaps = jax.lax.fori_loop(
        0, n, body, (s, jnp.zeros((), cdtype), jnp.zeros((), jnp.int32))
    )
    pi = jnp.asarray(jnp.pi, _real_dtype(cdtype))
    return logdet + 1j * pi * (swaps % 2).astype(_real_dtype(cdtype))


def slogdet(s: jax.Array) -> jax.Array:
    """Batched complex log-determinant (log|det| + i arg det), [...]."""
    if s.shape[-1] == 0:
        # det of the 0x0 matrix is 1 (empty product) — arises for fully
        # spin-polarized systems (ndown=0 overlap blocks).
        return jnp.zeros(s.shape[:-2], s.dtype)
    flat = s.reshape((-1,) + s.shape[-2:])
    out = jax.vmap(_slogdet_single)(flat)
    return out.reshape(s.shape[:-2])
