"""Lane-parallel small-matrix linear algebra (walker axis LAST).

Every operation keeps the WALKER axis last: matrices are [n, m, W] with
W = batch. Factorizations are unrolled over the (static, tiny) matrix
dimension as chains of elementwise [rows, W] vector ops that XLA fuses —
no batched-LAPACK call and no scatter. Whether this beats the batched
[w, n, n] layout on a given device is a measurement (ROADMAP).

Counterpart of the per-walker numpy calls in the reference hot loop
(``pauxy/walkers/single_det.py:170-321`` overlaps/inverses,
``:215-255`` reorthogonalisation).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def to_lanes(x: jax.Array) -> jax.Array:
    """[w, ...] -> [..., w] (walker axis to the lanes)."""
    return jnp.moveaxis(x, 0, -1)


def from_lanes(x: jax.Array) -> jax.Array:
    """[..., w] -> [w, ...]."""
    return jnp.moveaxis(x, -1, 0)


def matmul_left(a: jax.Array, x: jax.Array) -> jax.Array:
    """a [p, m] @ x [m, n, W] -> [p, n, W] as ONE 2-D matmul [p, m] @
    [m, n*W] (the kinetic/B-matrix application; one GEMM, no batching).
    """
    m, n, w = x.shape
    return (a @ x.reshape(m, n * w)).reshape(a.shape[0], n, w)


def overlap_lanes(psi: jax.Array, phi: jax.Array) -> jax.Array:
    """S[i, j, W] = sum_m conj(psi)[m, i] phi[m, j, W] — the trial overlap
    matrix as one 2-D matmul (psi^dag [n, M] @ phi [M, n*W])."""
    return matmul_left(psi.conj().T, phi)


def gauss(s: jax.Array, rhs: jax.Array | None = None):
    """Partial-pivot Gaussian elimination, unrolled over the (static) n.

    s [n, n, W]; rhs [n, k, W] or None. Returns (logdet [W] complex,
    x [n, k, W] or None) with s @ x = rhs.

    Every step is an elementwise select/multiply on [rows, cols, W] blocks
    (lane-parallel across walkers); the per-lane row swap is a
    take_along_axis gather + masked select — no scatter.
    """
    n = s.shape[0]
    w = s.shape[-1]
    cdtype = jnp.result_type(s.dtype, jnp.complex64)
    if n == 0:
        # Empty system (fully spin-polarized 0-electron blocks): det = 1.
        zero = jnp.zeros((w,), cdtype)
        return zero, (None if rhs is None else rhs.astype(cdtype))
    aug = s if rhs is None else jnp.concatenate([s, rhs], axis=1)
    aug = aug.astype(cdtype)
    ncol = aug.shape[1]
    logdet = jnp.zeros((w,), cdtype)
    ipi = jnp.asarray(1j * jnp.pi, cdtype)
    done_rows = []
    for k in range(n):
        rows = aug                                   # [r, ncol, W], r = n - k
        r = rows.shape[0]
        col = jnp.abs(rows[:, k])                    # [r, W]
        piv = jnp.argmax(col, axis=0)                # [W]
        idx = jnp.broadcast_to(piv[None, None, :], (1, ncol, w))
        sel = jnp.take_along_axis(rows, idx, axis=0)  # [1, ncol, W]
        # Put the old top row where the pivot came from (masked select).
        mask = jnp.arange(r)[:, None, None] == piv[None, None, :]
        swapped = jnp.where(mask, rows[0:1], rows)
        rows = jnp.concatenate([sel, swapped[1:]], axis=0)
        logdet = logdet + jnp.where(piv > 0, ipi, 0.0)  # det *= -1 on swap
        pivval = rows[0, k]                           # [W]
        logdet = logdet + jnp.log(pivval)
        if r > 1:
            factors = rows[1:, k] / pivval            # [r-1, W]
            rows = jnp.concatenate(
                [rows[0:1], rows[1:] - factors[:, None, :] * rows[0:1]],
                axis=0,
            )
        done_rows.append(rows[0])
        aug = rows[1:]
    if rhs is None:
        return logdet, None
    # Back substitution on the upper-triangular system.
    k = rhs.shape[1]
    xs = [None] * n
    for i in range(n - 1, -1, -1):
        acc = done_rows[i][n:]                        # [k, W]
        for j in range(i + 1, n):
            acc = acc - done_rows[i][j][None, :] * xs[j]
        xs[i] = acc / done_rows[i][i][None, :]
    return logdet, jnp.stack(xs, axis=0)


def slogdet(s: jax.Array) -> jax.Array:
    """Complex log-determinant of [n, n, W] (lane-parallel LU)."""
    logdet, _ = gauss(s)
    return logdet


def solve(s: jax.Array, rhs: jax.Array) -> jax.Array:
    """x with s @ x = rhs, s [n, n, W], rhs [n, k, W]."""
    _, x = gauss(s, rhs)
    return x


def _chol_r(g: jax.Array) -> jax.Array:
    """Upper-triangular R with R^dag R = g (Hermitian PD [n, n, W]),
    unrolled lane-parallel Cholesky. Returns R [n, n, W] (strictly lower
    part garbage-free zeros)."""
    n = g.shape[0]
    w = g.shape[-1]
    rows = []
    for i in range(n):
        # R[i, j] = (g[i, j] - sum_{k<i} conj(R[k, i]) R[k, j]) / R[i, i]
        acc = g[i]                                    # [n, W]
        for k in range(i):
            acc = acc - rows[k][i].conj()[None, :] * rows[k]
        dii = jnp.sqrt(acc[i].real).astype(g.dtype)   # [W]
        row = acc / dii[None, :]
        row = row.at[i].set(dii)  # static index update (not scatter)
        # Zero the strictly-lower part for cleanliness.
        row = jnp.where(jnp.arange(n)[:, None] < i, 0.0, row)
        rows.append(row)
    return jnp.stack(rows, axis=0)


def _solve_upper_right(phi: jax.Array, r: jax.Array) -> jax.Array:
    """X = phi @ R^-1 for upper-triangular R [n, n, W], phi [m, n, W]:
    column-by-column forward substitution (X[:, j] = (phi[:, j] -
    sum_{k<j} X[:, k] R[k, j]) / R[j, j])."""
    n = r.shape[0]
    cols = []
    for j in range(n):
        acc = phi[:, j]                               # [m, W]
        for k in range(j):
            acc = acc - cols[k] * r[k, j][None, :]
        cols.append(acc / r[j, j][None, :])
    return jnp.stack(cols, axis=1)


def cholesky_qr2(phi: jax.Array):
    """CholeskyQR2 re-orthogonalisation in lanes layout.

    phi [m, n, W] -> (q [m, n, W], log_detr [W] real) with q^dag q = I and
    det(R) real positive (R = R2 R1 upper with positive diagonal), matching
    ``ops.clinalg.cholesky_qr`` semantics on the [w, m, n] layout.
    """
    if phi.shape[1] == 0:
        # 0-column determinant blocks (fully spin-polarized): Q empty,
        # log det R = 0.
        return phi, jnp.zeros(phi.shape[-1:], phi.real.dtype)
    g1 = gram(phi)
    r1 = _chol_r(g1)
    q1 = _solve_upper_right(phi, r1)
    g2 = gram(q1)
    r2 = _chol_r(g2)
    q = _solve_upper_right(q1, r2)
    n = r1.shape[0]
    diag = jnp.arange(n)
    log_detr = jnp.sum(
        jnp.log(r1[diag, diag].real) + jnp.log(r2[diag, diag].real), axis=0
    )
    return q, log_detr


def gram(phi: jax.Array) -> jax.Array:
    """G[i, j, W] = sum_m conj(phi)[m, i, W] phi[m, j, W], unrolled over i
    (elementwise multiply + reduce per row; avoids a lane-batched
    dot_general that XLA would wrap in [W, n, n] transposes)."""
    n = phi.shape[1]
    rows = [
        jnp.sum(phi[:, i : i + 1].conj() * phi, axis=0)   # [n, W]
        for i in range(n)
    ]
    return jnp.stack(rows, axis=0)
