"""FCI validation-module tests (mirrors pauxy/estimators/tests/test_ci.py)."""

import os
import sys

import numpy as np
import pytest

from pauxy_jax.estimators import ci
from pauxy_jax.models import make_generic, make_hubbard
from pauxy_jax.utils.testing import generate_hamiltonian

HAVE_REF = os.path.isdir("/root/reference/pauxy")
if HAVE_REF:
    sys.path.insert(0, "/root/reference")


@pytest.mark.unit
def test_hubbard_dimer_exact():
    """2-site Hubbard at half filling: E0 = (U - sqrt(U^2 + 16 t^2))/2."""
    # Note: nx=2 with PBC doubles the hopping bond (wrap + direct), so use
    # open boundaries for the textbook dimer.
    ham = make_hubbard(nup=1, ndown=1, U=4.0, nx=2, ny=1, xpbc=False)
    e, _, _ = ci.simple_fci(ham)
    t = 1.0
    exact = 0.5 * (4.0 - np.sqrt(16.0 + 16.0 * t ** 2))
    assert e[0] == pytest.approx(exact, abs=1e-10)


@pytest.mark.unit
def test_fci_vs_reference_hubbard():
    if not HAVE_REF:
        pytest.skip("no reference")
    from pauxy.estimators.ci import simple_fci as ref_fci
    from pauxy.systems.hubbard import Hubbard as RefHubbard

    sys_ref = RefHubbard(
        {"nx": 3, "ny": 1, "nup": 2, "ndown": 1, "U": 4.0, "ktwist": [0.0]}
    )
    (eref, _) = ref_fci(sys_ref)
    ham = make_hubbard(nup=2, ndown=1, U=4.0, nx=3, ny=1)
    e, _, _ = ci.simple_fci(ham, nroots=4)
    np.testing.assert_allclose(e[:4], np.asarray(eref)[:4], atol=1e-10)


@pytest.mark.unit
def test_fci_vs_reference_generic():
    if not HAVE_REF:
        pytest.skip("no reference")
    from pauxy.estimators.ci import simple_fci as ref_fci

    h1e, chol, enuc, eri = generate_hamiltonian(4, (2, 1), seed=9)
    ham = make_generic((2, 1), h1e, chol, 0.0)

    class S:
        pass

    s = S()
    s.nup, s.ndown, s.nbasis = 2, 1, 4
    s.H1 = np.stack([h1e, h1e])
    s.ecore = 0.0

    def hijkl(i, j, k, l):
        # reference convention: hijkl(i,j,k,l) = <ij|kl> = (ik|jl)
        return eri[i, k, j, l]

    s.hijkl = hijkl
    eref, _ = ref_fci(s)
    e, _, _ = ci.simple_fci(ham, nroots=3)
    np.testing.assert_allclose(e[:3], np.asarray(eref)[:3], atol=1e-8)


@pytest.mark.driver
def test_free_projection_converges_to_fci(tmp_path):
    """Free-projection AFQMC on a tiny Hubbard lattice approaches the FCI
    ground state (the reference's strongest physics check)."""
    from pauxy_jax.models.trial import free_electron_trial
    from pauxy_jax.qmc import AFQMC, QMCOpts

    ham = make_hubbard(nup=2, ndown=2, U=4.0, nx=4, ny=1)
    e_fci, _, _ = ci.simple_fci(ham)
    trial = free_electron_trial(ham)
    qmc = QMCOpts(nwalkers=400, dt=0.01, nsteps=25, nblocks=10, nstblz=5,
                  npop_control=1000000, rng_seed=4)
    af = AFQMC(
        ham, trial, qmc,
        propagator_options={"free_projection": True},
        estimator_options={"mixed": {"energy_eval_freq": 5}},
        filename=str(tmp_path / "fp.h5"),
    )
    rows = af.run()
    # Projected energy Re(<psi_T|H|phi>/<psi_T|phi>) at late tau.
    e_fp = rows[-1, 5].real
    assert abs(e_fp - e_fci[0]) < 0.05, (e_fp, e_fci[0])


@pytest.mark.unit
def test_bose_fermi_fci_vs_reference_pinned():
    """Hubbard-Holstein bose-fermi FCI against the reference's pinned
    ground-state energies (``pauxy/estimators/tests/test_ci.py:19-52``)."""
    from pauxy_jax.estimators.ci import simple_fci_bose_fermi
    from pauxy_jax.models.hubbard_holstein import make_hubbard_holstein

    ham = make_hubbard_holstein(nup=1, ndown=1, U=0.0, nx=2, ny=1,
                                w0=0.8, lmbda=0.5)
    e, _, _ = simple_fci_bose_fermi(ham, nboson_max=20)
    assert e[0] == pytest.approx(-6.232530237466693, abs=1e-8)

    ham = make_hubbard_holstein(nup=1, ndown=1, U=4.0, nx=3, ny=1,
                                w0=0.8, lmbda=0.5)
    e, _, _ = simple_fci_bose_fermi(ham, nboson_max=12)
    assert e[0] == pytest.approx(-4.642361166625703, abs=1e-5)


@pytest.mark.unit
def test_one_rdm_from_fci():
    """FCI 1-RDM oracle: trace = n per spin, hermitian; at U=0 it equals
    the sum of the lowest-orbital projectors; and the RDM-contracted
    one-body energy matches the FCI kinetic expectation."""
    import numpy as np

    from pauxy_jax.estimators.ci import one_rdm_from_fci, simple_fci
    from pauxy_jax.models import make_hubbard

    ham = make_hubbard(nup=2, ndown=2, U=0.0, nx=4, xpbc=False)
    ev, evec, basis = simple_fci(ham)
    p = one_rdm_from_fci(evec[:, 0], basis, ham.nbasis)
    assert p[0].trace().real == pytest.approx(2.0, abs=1e-10)
    assert p[1].trace().real == pytest.approx(2.0, abs=1e-10)
    np.testing.assert_allclose(p[0], p[0].conj().T, atol=1e-12)
    h = np.asarray(ham.T)[0]
    e, v = np.linalg.eigh(h)
    proj = v[:, :2] @ v[:, :2].conj().T
    # P_pq = <c_p^dag c_q>: for a filled Fermi sea this is the projector
    # onto the occupied orbitals (transposed convention is symmetric here).
    np.testing.assert_allclose(p[0].real, proj.real, atol=1e-10)
    ke = np.einsum("pq,spq->", h, p).real
    assert ke == pytest.approx(ev[0], abs=1e-10)

    # Interacting cross-check: the RDM-contracted one-body energy plus the
    # FCI eigendecomposition stays consistent under U > 0 (trace and
    # hermiticity still exact; energy check via Hellmann-Feynman-free
    # contraction is covered by the U=0 case above).
    ham4 = make_hubbard(nup=2, ndown=2, U=4.0, nx=4, xpbc=False)
    ev4, evec4, basis4 = simple_fci(ham4)
    p4 = one_rdm_from_fci(evec4[:, 0], basis4, ham4.nbasis)
    assert p4[0].trace().real == pytest.approx(2.0, abs=1e-10)
    np.testing.assert_allclose(p4[0], p4[0].conj().T, atol=1e-12)
    # Double occupancy from the FCI vector directly must match
    # dE/dU = sum_i <n_i_up n_i_down> bounds: 0 < D < n_up.
    docc = sum(
        abs(evec4[i, 0]) ** 2 * len(set(a) & set(b))
        for i, (a, b) in enumerate(basis4)
    )
    e1 = np.einsum("pq,spq->", np.asarray(ham4.T)[0], p4).real
    assert ev4[0] == pytest.approx(e1 + 4.0 * docc, abs=1e-10)
