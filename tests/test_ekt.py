"""EKT Fock matrices vs the reference implementation."""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest

from pauxy_jax.estimators import ekt
from pauxy_jax.utils.testing import generate_hamiltonian


@pytest.mark.unit
def test_ekt_vs_reference():
    if not os.path.isdir("/root/reference/pauxy"):
        pytest.skip("no reference")
    sys.path.insert(0, "/root/reference")
    from pauxy.estimators.ekt import ekt_1h_fock_opt, ekt_1p_fock_opt

    rng = np.random.default_rng(0)
    m = 5
    h1e, chol, _, _ = generate_hamiltonian(m, (2, 2), seed=1)
    pa = rng.standard_normal((m, m)) + 1j * rng.standard_normal((m, m))
    pb = rng.standard_normal((m, m)) + 1j * rng.standard_normal((m, m))

    chol_ref = np.moveaxis(chol, -1, 0)                   # [X, M, M]
    f1p_ref = ekt_1p_fock_opt(h1e, chol_ref, pa, pb)
    f1h_ref = ekt_1h_fock_opt(h1e, chol_ref, pa, pb)

    f1p = np.asarray(
        ekt.ekt_1p_fock(jnp.asarray(h1e), jnp.asarray(chol),
                        jnp.asarray(pa[None]), jnp.asarray(pb[None]))
    )[0]
    f1h = np.asarray(
        ekt.ekt_1h_fock(jnp.asarray(h1e), jnp.asarray(chol),
                        jnp.asarray(pa[None]), jnp.asarray(pb[None]))
    )[0]
    np.testing.assert_allclose(f1p, f1p_ref, atol=1e-10)
    np.testing.assert_allclose(f1h, f1h_ref, atol=1e-10)
