"""Batched column-pivoted Householder QR (complex), in pure jax.

The finite-temperature stabilized propagator products (QDT stratification,
``pauxy/walkers/thermal.py:472-545`` and ``pauxy/estimators/
thermal.py:147-196``) are built on scipy's column-pivoted QR. This module
implements it directly: a ``fori_loop`` over columns doing masked rank-1
Householder updates, batched over walkers/spins. O(m) sequential steps of
O(batch * m^2) elementwise work — the batch axis keeps the device busy.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def cpqr(a: jax.Array, pivot: bool = True):
    """Column-pivoted QR: A[..., :, perm] = Q R.

    Returns (q, r, perm) with q unitary [..., m, m], r upper triangular,
    perm [..., m] int32 such that a[..., :, perm] = q @ r (i.e. column j of
    the pivoted A is original column perm[j] — scipy.linalg.qr(pivoting=True)
    convention).
    """
    return _cpqr_xla(a, pivot)


# Exact partial-norm recompute period for the downdating pivoted loop.
# 1 = recompute every column (bit-identical pivots to the textbook loop);
# higher saves one full-matrix reduction per non-refresh column.
CPQR_NORM_REFRESH = 16


def _cpqr_xla(a: jax.Array, pivot: bool = True):
    """Deferred-pivot Householder + compact WY.

    Three memory-traffic optimizations over the textbook loop (physical
    column swaps and a per-step rank-1 Q update):

    * No physical column swaps: the pivot is selected by masking processed
      columns (LAPACK xGEQP3-style deferred permutation), the reflection is
      applied to ALL columns (processed columns are provably invariant:
      they are zero on rows >= k, the support of v_k), and the columns are
      put in pivot order by ONE one-hot matmul at the end — removing a
      full-matrix gather per step.
    * Q is never carried through the loop. The Householder vectors V and
      scalars tau accumulate in-place, and Q = I - V T V^H is formed once
      at the end via the compact-WY identity T^{-1} = diag(1/tau) +
      striu(V^H V) — two matmuls plus one small triangular solve
      replace 2 rank-1 full-matrix updates per step.
    * Partial column norms are DOWNDATED (LAPACK xGEQP3-style): the
      reflection preserves each column's norm over the active rows, so
      norms_{k+1} = norms_k - |row k of the updated R|^2, costing one
      [batch, m] row read instead of a full matrix reduction. An exact
      recompute every CPQR_NORM_REFRESH columns bounds the f32 drift
      (the drift can only reorder near-tied pivots, never break the
      factorization identities).
    """
    *batch, mrow, m = a.shape
    assert mrow == m, "square matrices only"
    cdtype = a.dtype
    rdtype = jnp.zeros((), cdtype).real.dtype
    rows = jnp.arange(m)

    r0 = a
    v0 = jnp.zeros_like(a)                                # columns = v_k
    tau0 = jnp.zeros((*batch, m), cdtype)
    perm0 = jnp.broadcast_to(rows, (*batch, m))
    done0 = jnp.zeros((*batch, m), bool)
    norms0 = jnp.sum(jnp.abs(a) ** 2, axis=-2)            # rows >= 0

    def exact_norms(r, done, k):
        active_row = (rows >= k)
        n = jnp.sum(
            jnp.abs(r) ** 2 * active_row[..., :, None].astype(rdtype),
            axis=-2,
        )
        return jnp.where(done, -1.0, n)

    def body(k, carry):
        r, vmat, tau, perm, done, norms = carry
        active_row = (rows >= k)                           # [m]

        if pivot:
            norms = jax.lax.cond(
                k % CPQR_NORM_REFRESH == 0,
                lambda r, d, n: exact_norms(r, d, k),
                lambda r, d, n: n,
                r, done, norms,
            )
            p = jnp.argmax(norms, axis=-1)                 # [...]
        else:
            p = jnp.broadcast_to(jnp.asarray(k), tuple(batch))
        pb = p[..., None]

        # Householder vector from pivot column p, rows >= k.
        x = jnp.take_along_axis(r, pb[..., None, :], axis=-1)[..., 0]
        x = x * active_row.astype(rdtype)                  # [..., m]
        normx = jnp.sqrt(jnp.sum(jnp.abs(x) ** 2, axis=-1))
        x0 = jnp.sum(x * (rows == k).astype(rdtype), axis=-1)
        absx0 = jnp.abs(x0)
        phase = jnp.where(absx0 > 0, x0 / jnp.where(absx0 > 0, absx0, 1.0), 1.0)
        alpha = -phase * normx.astype(cdtype)
        v = x - alpha[..., None] * (rows == k).astype(cdtype)
        vsq = jnp.sum(jnp.abs(v) ** 2, axis=-1)
        ok = vsq > 1e-300
        # Store the UNIT-normalized vector with tau = 2 (H = I - 2 u u^H):
        # unnormalized v's inherit the column scales, which makes the
        # compact-WY T^{-1} = diag(1/tau) + striu(V^H V) arbitrarily badly
        # balanced and costs ~20x accuracy in the formed Q (measured at
        # f32, m=93, columns scaled exp(N(0,2))). Unit columns keep
        # |V^H V| <= 1 against a 0.5 diagonal.
        rnorm = jnp.where(ok, jax.lax.rsqrt(jnp.where(ok, vsq, 1.0)), 0.0)
        v = v * rnorm[..., None].astype(cdtype)            # unit (or zero)
        tk = jnp.where(ok, 2.0, 0.0).astype(cdtype)

        # r <- (I - tau v v^H) r ; processed columns are unchanged by this
        # (their rows >= k vanish), so no column mask is needed.
        w = jnp.einsum("...m,...mn->...n", v.conj(), r) * tk[..., None]
        r = r - v[..., :, None] * w[..., None, :]

        vmat = vmat + v[..., :, None] * (rows == k).astype(cdtype)
        tau = tau + tk[..., None] * (rows == k).astype(cdtype)
        perm = jnp.where(rows == k, pb, perm)
        done = done | (rows == pb)
        if pivot:
            # Reflections are unitary on rows >= k, so the norm over rows
            # >= k+1 is the old norm minus the now-final row k entry.
            rowk = jnp.abs(r[..., k, :]) ** 2              # [..., m]
            norms = jnp.where(done, -1.0, jnp.maximum(norms - rowk, 0.0))
        return r, vmat, tau, perm, done, norms

    r, vmat, tau, perm, _done, _norms = jax.lax.fori_loop(
        0, m, body, (r0, v0, tau0, perm0, done0, norms0)
    )

    # Q = H_0 H_1 ... H_{m-1} = I - V T V^H (compact WY), with
    # T^{-1} = diag(1/tau) + striu(V^H V); tau = 0 columns carry v = 0, so
    # a unit diagonal entry there leaves Q untouched.
    #
    # Every matrix-matrix product below is pinned to Precision.HIGHEST so
    # that a reduced matmul-precision tier (config.set_matmul_precision)
    # cannot degrade the formed Q. These are O(m^3) once per factorization
    # vs the loop's O(m^3) total, so full precision here is noise in the
    # runtime.
    from pauxy_jax.ops import clinalg

    hi = jax.lax.Precision.HIGHEST
    g = jnp.einsum("...mk,...mn->...kn", vmat.conj(), vmat, precision=hi)
    abst = jnp.abs(tau)
    safe_diag = jnp.where(abst > 0, 1.0 / jnp.where(abst > 0, tau, 1.0), 1.0)
    eye = jnp.eye(m, dtype=cdtype)
    tinv = jnp.triu(g, 1) + safe_diag[..., :, None] * eye
    vh = jnp.swapaxes(vmat.conj(), -1, -2)
    if jnp.iscomplexobj(a):
        tvh = jnp.einsum(
            "...kj,...jn->...kn", clinalg.inv(tinv), vh, precision=hi
        )
    else:
        tvh = jnp.linalg.solve(tinv, vh)
    q = jnp.broadcast_to(eye, a.shape) - jnp.einsum(
        "...mk,...kn->...mn", vmat, tvh, precision=hi
    )

    # One deferred column permutation: r_piv[:, j] = r[:, perm[j]].
    # HIGHEST is exactness, not accuracy, here: a reduced-precision one-hot
    # matmul would truncate the selected values.
    sel = (perm[..., None, :] == rows[:, None]).astype(cdtype)  # [..., m, m]
    r = jnp.einsum("...mk,...kn->...mn", r, sel, precision=hi)
    tri = (rows[:, None] <= rows[None, :]).astype(cdtype)
    return q, r * tri, perm.astype(jnp.int32)


def unpermute_columns(t: jax.Array, perm: jax.Array) -> jax.Array:
    """Given T acting on pivoted columns, return T' with T'[:, perm[j]] =
    T[:, j] (undo the pivoting; thermal.py:160-162).

    Implemented as one one-hot matmul rather than argsort +
    take_along_axis.
    """
    m = t.shape[-1]
    cols = jnp.arange(m)
    # P[j, i] = 1 iff i == perm[j]  ->  (T @ P)[:, i] = T[:, j=perm^-1(i)].
    # HIGHEST precision makes the one-hot selection exact under any
    # matmul-precision tier.
    p = (perm[..., :, None] == cols).astype(t.dtype)      # [..., m, m]
    return jnp.einsum(
        "...mk,...kn->...mn", t, p, precision=jax.lax.Precision.HIGHEST
    )
