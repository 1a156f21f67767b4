"""Unit tests for batched Green's function / overlap / reortho kernels.

Style mirrors the reference's unit tier (SURVEY.md section 4): each kernel is
checked against an independently coded dense numpy calculation in the test
body.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pauxy_jax.ops import greens


def random_slater(rng, nw, m, n):
    return rng.standard_normal((nw, m, n)) + 1j * rng.standard_normal((nw, m, n))


@pytest.mark.unit
def test_greens_function_vs_dense():
    rng = np.random.default_rng(7)
    nw, m, n = 4, 9, 3
    phi = random_slater(rng, nw, m, n)
    psi = (rng.standard_normal((m, n)) + 1j * rng.standard_normal((m, n)))

    out = greens.greens_function(jnp.asarray(phi), jnp.asarray(psi))
    for w in range(nw):
        s = phi[w].T @ psi.conj()
        ghalf = np.linalg.inv(s) @ phi[w].T
        g = psi.conj() @ ghalf
        sign, logdet = np.linalg.slogdet(s)
        np.testing.assert_allclose(np.asarray(out.Ghalf[w]), ghalf, atol=1e-10)
        np.testing.assert_allclose(np.asarray(out.G[w]), g, atol=1e-10)
        np.testing.assert_allclose(
            np.exp(np.asarray(out.log_ovlp[w])), sign * np.exp(logdet), rtol=1e-10
        )


@pytest.mark.unit
def test_greens_idempotent_projector():
    # G is invariant under phi -> phi R (right multiplication by invertible R).
    rng = np.random.default_rng(3)
    phi = random_slater(rng, 2, 8, 4)
    psi = rng.standard_normal((8, 4)) + 1j * rng.standard_normal((8, 4))
    r = rng.standard_normal((2, 4, 4)) + 1j * rng.standard_normal((2, 4, 4))
    g1 = greens.greens_function(jnp.asarray(phi), jnp.asarray(psi)).G
    g2 = greens.greens_function(jnp.asarray(phi @ r), jnp.asarray(psi)).G
    np.testing.assert_allclose(np.asarray(g1), np.asarray(g2), atol=1e-9)


@pytest.mark.unit
def test_log_overlap_matches_greens():
    rng = np.random.default_rng(11)
    phi = jnp.asarray(random_slater(rng, 3, 7, 2))
    psi = jnp.asarray(rng.standard_normal((7, 2)) + 1j * rng.standard_normal((7, 2)))
    lo = greens.log_overlap(phi, psi)
    sg = greens.greens_function(phi, psi)
    np.testing.assert_allclose(np.asarray(lo), np.asarray(sg.log_ovlp), atol=1e-12)


@pytest.mark.unit
def test_reortho_preserves_determinant_state():
    """phi = Q R with R diag > 0; overlap of Q equals overlap of phi minus
    log det R — the invariant behind single_det.py:215-255."""
    rng = np.random.default_rng(5)
    phi = jnp.asarray(random_slater(rng, 4, 10, 3))
    psi = jnp.asarray(rng.standard_normal((10, 3)) + 1j * rng.standard_normal((10, 3)))
    lo_before = greens.log_overlap(phi, psi)
    q, log_detr = greens.reortho(phi)
    # Orthonormal columns.
    qhq = jnp.einsum("wmi,wmj->wij", q.conj(), q)
    np.testing.assert_allclose(
        np.asarray(qhq), np.broadcast_to(np.eye(3), (4, 3, 3)), atol=1e-10
    )
    # Same span: overlap shifts by exactly log det R.
    lo_after = greens.log_overlap(q, psi)
    ratio = np.asarray(lo_before - lo_after - log_detr)
    # Real part must vanish; imaginary part is a multiple of 2 pi.
    np.testing.assert_allclose(ratio.real, 0.0, atol=1e-10)
    np.testing.assert_allclose(
        np.mod(np.abs(ratio.imag) + np.pi, 2 * np.pi) - np.pi, 0.0, atol=1e-8
    )
    assert np.all(np.asarray(log_detr) > -np.inf)


@pytest.mark.unit
def test_gab_matches_definition():
    rng = np.random.default_rng(9)
    a = rng.standard_normal((6, 2)) + 1j * rng.standard_normal((6, 2))
    b = rng.standard_normal((6, 2)) + 1j * rng.standard_normal((6, 2))
    g = np.asarray(greens.gab(jnp.asarray(a), jnp.asarray(b)))
    inv = np.linalg.inv(a.conj().T @ b)
    np.testing.assert_allclose(g, b @ inv @ a.conj().T, atol=1e-10)
