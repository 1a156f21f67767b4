"""Hubbard system construction vs the reference implementation.

The read-only reference checkout at /root/reference is used directly as the
oracle where available (it needs no MPI for system construction).
"""

import os
import sys

import numpy as np
import pytest

from pauxy_jax.models import make_hubbard
from pauxy_jax.models.hubbard import band_energies, kinetic_matrix

REFERENCE = "/root/reference"
HAVE_REF = os.path.isdir(os.path.join(REFERENCE, "pauxy"))


def _ref_hubbard(opts):
    sys.path.insert(0, REFERENCE)
    from pauxy.systems.hubbard import Hubbard as RefHubbard

    return RefHubbard(opts)


@pytest.mark.unit
@pytest.mark.skipif(not HAVE_REF, reason="reference checkout not available")
@pytest.mark.parametrize(
    "nx,ny,twist",
    [(4, 4, None), (3, 3, [0.01, -0.02]), (6, 1, None), (5, 1, [0.1]), (2, 2, None)],
)
def test_hopping_matches_reference(nx, ny, twist):
    opts = {"nx": nx, "ny": ny, "nup": 3, "ndown": 3, "U": 4.0}
    if twist is not None:
        opts["ktwist"] = twist
    else:
        # numpy>=2 broke the reference's `array(None).all() is None` probe
        # (hubbard_holstein.py:234); zero twist is mathematically identical.
        opts["ktwist"] = [0.0, 0.0] if ny > 1 else [0.0]
    ref = _ref_hubbard(opts)
    ref_t = np.asarray(ref.T)
    if twist is None:
        assert np.abs(ref_t.imag).max() < 1e-14
        ref_t = ref_t.real
    ham = make_hubbard(nup=3, ndown=3, U=4.0, nx=nx, ny=ny, ktwist=twist)
    np.testing.assert_allclose(np.asarray(ham.T), ref_t, atol=1e-12)
    np.testing.assert_allclose(
        np.asarray(ham.h1e_mod), np.asarray(ref.h1e_mod).real
        if twist is None else np.asarray(ref.h1e_mod), atol=1e-12
    )
    np.testing.assert_allclose(np.asarray(ham.eks), ref.eks, atol=1e-12)


@pytest.mark.unit
def test_kinetic_hermitian_and_bandsum():
    t = kinetic_matrix(1.0, 4, 4)
    assert np.allclose(t, t.conj().T)
    # Band energies sum to tr(T) = 0 for the pure hopping matrix.
    assert abs(band_energies(1.0, 4, 4).sum()) < 1e-12
    # Eigenvalues of T equal the band energies.
    np.testing.assert_allclose(
        np.sort(np.linalg.eigvalsh(t)), np.sort(band_energies(1.0, 4, 4)), atol=1e-12
    )


@pytest.mark.unit
def test_pinning_fields():
    from pauxy_jax.models.hubbard import pinned_kinetic

    t2 = pinned_kinetic(1.0, 4, 4)
    assert t2.shape == (2, 16, 16)
    # Staggered field on the ix=0 column only, opposite for spins.
    diag_up = np.diagonal(t2[0])
    diag_dn = np.diagonal(t2[1])
    np.testing.assert_allclose(diag_up, -diag_dn, atol=1e-14)
    for i in range(16):
        x, y = i % 4, i // 4
        expect = 0.1 * (-1.0) ** y if x == 0 else 0.0
        assert diag_up[i] == pytest.approx(expect)
    # System builds and is spin-asymmetric.
    ham = make_hubbard(nup=7, ndown=7, U=4.0, nx=4, ny=4, pinning_fields=True)
    assert not np.allclose(np.asarray(ham.T[0]), np.asarray(ham.T[1]))


@pytest.mark.unit
def test_uhf_checkerboard_guess():
    from pauxy_jax.models.trial import uhf_trial

    ham = make_hubbard(nup=8, ndown=8, U=4.0, nx=4, ny=4)
    trial = uhf_trial(ham, initial="checkerboard")
    # Neel-ordered determinant: staggered spin density.
    psia = np.asarray(trial.psia)
    niup = np.einsum("mi,mi->m", psia, psia.conj()).real
    assert niup.sum() == pytest.approx(8.0)
    stagger = np.array([(-1.0) ** ((i % 4) + (i // 4)) for i in range(16)])
    assert abs(np.dot(stagger, niup)) > 4.0
