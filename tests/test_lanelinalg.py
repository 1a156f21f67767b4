"""Lane-parallel (walker-last) small-matrix linalg vs numpy/clinalg.

These kernels back the Hubbard fast path; they must agree with the batched
[w, n, n] reference implementations to float tolerance.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from pauxy_jax.ops import clinalg, lanelinalg as ll


def rand_c(shape, seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape) + 1j * rng.normal(size=shape)) * scale


@pytest.mark.parametrize("n", [1, 2, 5, 8])
def test_gauss_logdet_matches_numpy(n):
    w = 7
    s = rand_c((w, n, n), seed=n)
    # Keep it well-conditioned but non-trivial.
    s = s + 2 * np.eye(n)
    s_l = ll.to_lanes(jnp.asarray(s))
    logdet = np.asarray(ll.slogdet(s_l))
    sign, ld = np.linalg.slogdet(s)
    np.testing.assert_allclose(np.exp(logdet), sign * np.exp(ld), rtol=1e-10)


def test_gauss_solve_matches_numpy():
    w, n, k = 5, 7, 3
    s = rand_c((w, n, n), seed=1) + 2 * np.eye(n)
    b = rand_c((w, n, k), seed=2)
    x = np.asarray(ll.solve(ll.to_lanes(jnp.asarray(s)),
                            ll.to_lanes(jnp.asarray(b))))
    x = np.moveaxis(x, -1, 0)
    np.testing.assert_allclose(x, np.linalg.solve(s, b), atol=1e-10)


def test_gauss_pivoting_handles_zero_leading_pivot():
    """A matrix whose (0,0) entry is zero requires the row swap."""
    s = np.array([[[0.0, 1.0], [1.0, 0.5]]], dtype=complex)
    b = np.array([[[1.0], [2.0]]], dtype=complex)
    x = np.asarray(ll.solve(ll.to_lanes(jnp.asarray(s)),
                            ll.to_lanes(jnp.asarray(b))))
    x = np.moveaxis(x, -1, 0)
    np.testing.assert_allclose(x, np.linalg.solve(s, b), atol=1e-12)
    logdet = np.asarray(ll.slogdet(ll.to_lanes(jnp.asarray(s))))
    np.testing.assert_allclose(np.exp(logdet), np.linalg.det(s)[0],
                               atol=1e-12)


def test_matmul_left_and_overlap():
    w, m, n = 6, 12, 5
    a = rand_c((m, m), seed=3)
    phi = rand_c((w, m, n), seed=4)
    phi_l = ll.to_lanes(jnp.asarray(phi))
    got = np.moveaxis(np.asarray(ll.matmul_left(jnp.asarray(a), phi_l)), -1, 0)
    np.testing.assert_allclose(got, np.einsum("pm,wmn->wpn", a, phi),
                               atol=1e-12)
    psi = rand_c((m, n), seed=5)
    s = np.moveaxis(
        np.asarray(ll.overlap_lanes(jnp.asarray(psi), phi_l)), -1, 0
    )
    np.testing.assert_allclose(
        s, np.einsum("mi,wmj->wij", psi.conj(), phi), atol=1e-12
    )


def test_gram():
    w, m, n = 4, 10, 6
    phi = rand_c((w, m, n), seed=6)
    g = np.moveaxis(np.asarray(ll.gram(ll.to_lanes(jnp.asarray(phi)))), -1, 0)
    np.testing.assert_allclose(
        g, np.einsum("wmi,wmj->wij", phi.conj(), phi), atol=1e-12
    )


def test_cholesky_qr2_matches_clinalg():
    w, m, n = 5, 12, 6
    phi = rand_c((w, m, n), seed=7)
    phi_l = ll.to_lanes(jnp.asarray(phi))
    q_l, logr = ll.cholesky_qr2(phi_l)
    q = np.moveaxis(np.asarray(q_l), -1, 0)
    # Orthonormal columns.
    qq = np.einsum("wmi,wmj->wij", q.conj(), q)
    np.testing.assert_allclose(qq, np.broadcast_to(np.eye(n), (w, n, n)),
                               atol=1e-10)
    # Same Q + log det R as the [w, m, n] implementation.
    q_ref, logr_ref = clinalg.cholesky_qr2(jnp.asarray(phi))
    np.testing.assert_allclose(np.asarray(logr), np.asarray(logr_ref),
                               rtol=1e-9)
    np.testing.assert_allclose(q, np.asarray(q_ref), atol=1e-9)


def test_roundtrip_layouts():
    x = rand_c((3, 4, 5), seed=8)
    xl = ll.to_lanes(jnp.asarray(x))
    assert xl.shape == (4, 5, 3)
    np.testing.assert_array_equal(np.asarray(ll.from_lanes(xl)), x)
