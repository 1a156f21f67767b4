"""Complex-from-real linear algebra vs numpy (ops/clinalg.py must be exact
on every backend)."""

import jax.numpy as jnp
import numpy as np
import pytest

from pauxy_jax.ops import clinalg


def rand_c(rng, *shape):
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


@pytest.mark.unit
def test_solve():
    rng = np.random.default_rng(0)
    s = rand_c(rng, 5, 4, 4)
    y = rand_c(rng, 5, 4, 7)
    x = np.asarray(clinalg.solve(jnp.asarray(s), jnp.asarray(y)))
    np.testing.assert_allclose(x, np.linalg.solve(s, y), atol=1e-10)


@pytest.mark.unit
def test_cholesky():
    rng = np.random.default_rng(1)
    a = rand_c(rng, 3, 6, 6)
    s = a @ np.conj(np.swapaxes(a, -1, -2)) + 6 * np.eye(6)
    l = np.asarray(clinalg.cholesky(jnp.asarray(s)))
    np.testing.assert_allclose(l, np.linalg.cholesky(s), atol=1e-10)
    # lower triangular, real positive diagonal
    assert np.allclose(np.triu(l, 1), 0)
    d = np.diagonal(l, axis1=-2, axis2=-1)
    assert np.allclose(d.imag, 0) and np.all(d.real > 0)


@pytest.mark.unit
def test_triangular_solve_lower():
    rng = np.random.default_rng(2)
    a = rand_c(rng, 2, 5, 5)
    s = a @ np.conj(np.swapaxes(a, -1, -2)) + 5 * np.eye(5)
    l = np.linalg.cholesky(s)
    y = rand_c(rng, 2, 5, 3)
    x = np.asarray(clinalg.triangular_solve_lower(jnp.asarray(l), jnp.asarray(y)))
    np.testing.assert_allclose(l @ x, y, atol=1e-10)


@pytest.mark.unit
def test_cholesky_qr2():
    rng = np.random.default_rng(3)
    phi = rand_c(rng, 4, 12, 5)
    q, log_detr = clinalg.cholesky_qr2(jnp.asarray(phi))
    q = np.asarray(q)
    qhq = np.einsum("wmi,wmj->wij", q.conj(), q)
    np.testing.assert_allclose(qhq, np.broadcast_to(np.eye(5), (4, 5, 5)), atol=1e-12)
    # Same column span and consistent detR: det(phi^H phi) = det(R)^2 ...
    for w in range(4):
        s = phi[w].conj().T @ phi[w]
        _, ld = np.linalg.slogdet(s)
        np.testing.assert_allclose(float(log_detr[w]), 0.5 * ld, rtol=1e-9)
        # span check: projector difference vanishes
        pq = q[w] @ q[w].conj().T
        u, _, vh = np.linalg.svd(phi[w], full_matrices=False)
        pp = u @ u.conj().T
        np.testing.assert_allclose(pq, pp, atol=1e-9)


@pytest.mark.unit
def test_slogdet_phase():
    rng = np.random.default_rng(4)
    s = rand_c(rng, 6, 5, 5)
    out = np.asarray(clinalg.slogdet(jnp.asarray(s)))
    det = np.linalg.det(s)
    np.testing.assert_allclose(np.exp(out), det, rtol=1e-9)


@pytest.mark.unit
def test_slogdet_near_singular_pivoting():
    # Needs pivoting: leading principal minor is zero.
    s = np.array([[0.0, 1.0], [1.0, 0.0]], dtype=complex)
    out = complex(clinalg.slogdet(jnp.asarray(s[None]))[0])
    np.testing.assert_allclose(np.exp(out), -1.0, rtol=1e-12)
    # scaled + batched
    s2 = np.stack([s, 3.0 * np.eye(2)]).astype(complex)
    out2 = np.asarray(clinalg.slogdet(jnp.asarray(s2)))
    np.testing.assert_allclose(np.exp(out2), [-1.0, 9.0], rtol=1e-12)


@pytest.mark.unit
def test_solve_real_matrix_complex_rhs_keeps_imag():
    """solve() with a real S and complex Y must return the complex
    solution (casting to s.dtype would silently drop the imaginary
    half)."""
    rng = np.random.default_rng(3)
    s = jnp.asarray(
        (rng.standard_normal((4, 5, 5))
         + 5 * np.eye(5)).astype(np.float32))
    y = jnp.asarray(
        (rng.standard_normal((4, 5, 3))
         + 1j * rng.standard_normal((4, 5, 3))).astype(np.complex64))
    x = clinalg.solve(s, y)
    assert jnp.iscomplexobj(x)
    np.testing.assert_allclose(
        np.asarray(jnp.matmul(s, x)), np.asarray(y), atol=2e-4)
