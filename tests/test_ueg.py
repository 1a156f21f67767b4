"""UEG system + kernels vs the reference implementation.

The reference's Cython module isn't compiled here, so the oracles are its
pure-python fallback loops (``pauxy/estimators/ueg.py:14-25``) and the scipy
sparse operators of the system class itself.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest

from pauxy_jax.estimators import local_energy as le
from pauxy_jax.models import make_ueg, rhf_identity_trial
from pauxy_jax.ops import greens
from pauxy_jax.propagation.planewave import make_planewave
from pauxy_jax.utils.testing import random_wavefunction

REFERENCE = "/root/reference"
HAVE_REF = os.path.isdir(os.path.join(REFERENCE, "pauxy"))
if HAVE_REF:
    sys.path.insert(0, REFERENCE)


def _dense_rho_from_sparse(sp, nq, m):
    """Rebuild dense rho [nq, M, M] from the gather metadata (test oracle)."""
    qmap = np.asarray(sp.qmap)
    fac = np.asarray(sp.fac)
    rho = np.zeros((nq, m, m))
    a, b = np.nonzero(fac)
    rho[qmap[a, b], a, b] = fac[a, b]
    return rho


def ref_ueg(nup=7, ndown=7, rs=1.0, ecut=1.0):
    from pauxy.systems.ueg import UEG as RefUEG

    return RefUEG(
        {"nup": nup, "ndown": ndown, "rs": rs, "ecut": ecut, "thermal": True}
    )


@pytest.mark.unit
def test_system_vs_reference():
    if not HAVE_REF:
        pytest.skip("no reference")
    ref = ref_ueg()
    ham = make_ueg(nup=7, ndown=7, rs=1.0, ecut=1.0)
    assert ham.nbasis == ref.nbasis
    assert ham.nq == ref.nchol
    assert ham.nfields == ref.nfields
    np.testing.assert_allclose(np.asarray(ham.basis), ref.basis)
    np.testing.assert_allclose(np.asarray(ham.qvecs), ref.qvecs)
    np.testing.assert_allclose(np.asarray(ham.vqvec), ref.vqvec, atol=1e-12)
    np.testing.assert_allclose(np.diagonal(ham.H1[0]), ref.sp_eigv, atol=1e-12)
    np.testing.assert_allclose(
        np.asarray(ham.h1e_mod[0]), ref.h1e_mod[0], atol=1e-12
    )
    assert ham.ecore == pytest.approx(ref.ecore)
    # Sparse rho (scatter metadata) vs reference sparse chol_vecs
    # ([M^2, nq], column iq is rho_q raveled with rows kpq*M + i).
    from pauxy_jax.ops import ueg_sparse

    sp = ueg_sparse.make_sparse_rho(ham, np.float64)
    m, nq = ham.nbasis, ham.nq
    rho_ref = np.asarray(ref.chol_vecs.todense()).reshape(m, m, nq)
    rho_dense = _dense_rho_from_sparse(sp, nq, m)
    np.testing.assert_allclose(rho_dense, np.moveaxis(rho_ref, -1, 0),
                               atol=1e-12)
    # Gather maps vs reference index lists (thermal=True -> full-M maps).
    for iq in range(0, ham.nq, 7):
        mask = np.asarray(ham.kpq_mask[iq])
        np.testing.assert_array_equal(np.nonzero(mask)[0], ref.ikpq_i[iq])
        np.testing.assert_array_equal(
            np.asarray(ham.kpq_idx[iq])[mask], ref.ikpq_kpq[iq]
        )
        maskp = np.asarray(ham.pmq_mask[iq])
        np.testing.assert_array_equal(np.nonzero(maskp)[0], ref.ipmq_i[iq])
        np.testing.assert_array_equal(
            np.asarray(ham.pmq_idx[iq])[maskp], ref.ipmq_pmq[iq]
        )


@pytest.mark.unit
def test_local_energy_vs_reference_loops():
    if not HAVE_REF:
        pytest.skip("no reference")
    from pauxy.estimators.ueg import (
        coulomb_greens_function,
        exchange_greens_function,
    )

    ref = ref_ueg(nup=2, ndown=2, rs=1.0, ecut=0.5)
    ham = make_ueg(nup=2, ndown=2, rs=1.0, ecut=0.5)
    trial = rhf_identity_trial(ham)
    rng = np.random.default_rng(3)
    nw = 2
    phi = rng.standard_normal((nw, ham.nbasis, 4)) + 1j * rng.standard_normal(
        (nw, ham.nbasis, 4)
    )
    ga = greens.greens_function(jnp.asarray(phi[:, :, :2]), trial.psia)
    gb = greens.greens_function(jnp.asarray(phi[:, :, 2:]), trial.psib)
    etot, ke, pe = le.local_energy_ueg(ham, ga.G, gb.G)

    nq = ham.nq
    for w in range(nw):
        g = np.stack([np.asarray(ga.G[w]), np.asarray(gb.G[w])])
        gkpq = np.zeros((2, nq), dtype=complex)
        gpmq = np.zeros((2, nq), dtype=complex)
        gprod = np.zeros((2, nq), dtype=complex)
        for s in (0, 1):
            coulomb_greens_function(
                nq, ref.ikpq_i, ref.ikpq_kpq, ref.ipmq_i, ref.ipmq_pmq,
                gkpq[s], gpmq[s], g[s],
            )
            exchange_greens_function(
                nq, ref.ikpq_i, ref.ikpq_kpq, ref.ipmq_i, ref.ipmq_pmq,
                gprod[s], g[s],
            )
        fac = 1.0 / (2.0 * ham.vol)
        ess = fac * ref.vqvec.dot(
            (gkpq[0] * gpmq[0] - gprod[0]) + (gkpq[1] * gpmq[1] - gprod[1])
        )
        eos = fac * ref.vqvec.dot(gkpq[0] * gpmq[1] + gkpq[1] * gpmq[0])
        ke_ref = np.sum(ref.H1[0] * g[0] + ref.H1[1] * g[1])
        np.testing.assert_allclose(complex(ke[w]), ke_ref, rtol=1e-9)
        np.testing.assert_allclose(complex(pe[w]), ess + eos, rtol=1e-9)
        np.testing.assert_allclose(complex(etot[w]), ke_ref + ess + eos, rtol=1e-9)


@pytest.mark.unit
def test_planewave_force_bias_and_vhs_vs_reference():
    if not HAVE_REF:
        pytest.skip("no reference")
    import scipy.linalg

    ref = ref_ueg(nup=2, ndown=2, rs=1.0, ecut=0.5)
    ham = make_ueg(nup=2, ndown=2, rs=1.0, ecut=0.5)
    trial = rhf_identity_trial(ham)
    prop = make_planewave(ham, trial, 0.05)
    rng = np.random.default_rng(9)
    phi = rng.standard_normal((1, ham.nbasis, 4)) + 1j * rng.standard_normal(
        (1, ham.nbasis, 4)
    )
    ga = greens.greens_function(jnp.asarray(phi[:, :, :2]), trial.psia)
    gb = greens.greens_function(jnp.asarray(phi[:, :, 2:]), trial.psib)
    fb = np.asarray(prop.force_bias(trial, ga, gb))[0]

    g = np.stack([np.asarray(ga.G[0]), np.asarray(gb.G[0])])
    gvec = g.reshape(2, -1)
    nf = ham.nfields
    vbias = np.zeros(nf, dtype=complex)
    vbias[: nf // 2] = gvec[0].T * ref.iA + gvec[1].T * ref.iA
    vbias[nf // 2 :] = gvec[0].T * ref.iB + gvec[1].T * ref.iB
    np.testing.assert_allclose(fb, -np.sqrt(0.05) * vbias, atol=1e-10)

    # VHS + Taylor application
    x = rng.standard_normal(nf)
    # scipy sparse `*` vector is a matvec yielding the raveled VHS
    # (planewave.py:108-112).
    vhs_ref = np.sqrt(0.05) * np.asarray(
        ref.iA * x[: nf // 2] + ref.iB * x[nf // 2 :]
    ).reshape(ham.nbasis, ham.nbasis)
    pa, _ = prop.apply_vhs(
        jnp.asarray(phi[:, :, :2]),
        jnp.asarray(phi[:, :, 2:]),
        jnp.asarray(x[None]),
    )
    expref = scipy.linalg.expm(vhs_ref) @ phi[0, :, :2]
    np.testing.assert_allclose(np.asarray(pa[0]), expref, atol=1e-6)


@pytest.mark.driver
def test_ueg_afqmc_runs(tmp_path):
    from pauxy_jax.qmc import AFQMC, QMCOpts

    ham = make_ueg(nup=2, ndown=2, rs=1.0, ecut=0.5)
    trial = rhf_identity_trial(ham)
    qmc = QMCOpts(nwalkers=12, dt=0.01, nsteps=10, nblocks=5, nstblz=5,
                  npop_control=5, rng_seed=8)
    af = AFQMC(ham, trial, qmc,
               estimator_options={"mixed": {"energy_eval_freq": 1}},
               filename=str(tmp_path / "u.h5"))
    rows = af.run()
    assert np.isfinite(rows.real).all()


@pytest.mark.unit
def test_sparse_vhs_gather_and_expectations():
    """assemble_vhs (q-map gather) and rho_expectations must match dense
    einsums against rho rebuilt from the same metadata."""
    from pauxy_jax.ops import ueg_sparse

    ham = make_ueg(nup=2, ndown=2, rs=1.0, ecut=0.5)
    sp = ueg_sparse.make_sparse_rho(ham, np.float64)
    m, nq = ham.nbasis, ham.nq
    rho = _dense_rho_from_sparse(sp, nq, m)

    rng = np.random.default_rng(11)
    nw = 3
    c1 = rng.standard_normal((nw, nq)) + 1j * rng.standard_normal((nw, nq))
    c2 = rng.standard_normal((nw, nq)) + 1j * rng.standard_normal((nw, nq))
    want = np.einsum("qpm,wq->wpm", rho, c1) + np.einsum("qmp,wq->wpm", rho, c2)
    got = np.asarray(
        ueg_sparse.assemble_vhs(sp, jnp.asarray(c1), jnp.asarray(c2))
    )
    np.testing.assert_allclose(got, want, atol=1e-10)

    g = rng.standard_normal((nw, m, m)) + 1j * rng.standard_normal((nw, m, m))
    t1, t2 = ueg_sparse.rho_expectations(sp, jnp.asarray(g))
    np.testing.assert_allclose(np.asarray(t1), np.einsum("wpm,qpm->wq", g, rho),
                               atol=1e-10)
    np.testing.assert_allclose(np.asarray(t2), np.einsum("wpm,qmp->wq", g, rho),
                               atol=1e-10)


@pytest.mark.unit
def test_exchange_kernel_walker_chunking():
    """The recursive walker split must agree with the unchunked kernel."""
    ham = make_ueg(nup=2, ndown=2, rs=1.0, ecut=0.5)
    rng = np.random.default_rng(5)
    m = ham.nbasis
    g = rng.standard_normal((5, m, m)) + 1j * rng.standard_normal((5, m, m))
    full = np.asarray(le.exchange_greens_function_ueg(ham, jnp.asarray(g)))
    # Budget so small that one q per step with all walkers still busts it.
    tiny = np.asarray(
        le.exchange_greens_function_ueg(ham, jnp.asarray(g),
                                        max_elems=2 * m * m)
    )
    np.testing.assert_allclose(tiny, full, atol=1e-10)


@pytest.mark.unit
def test_ueg_fft_energy_matches_gather_kernel():
    """The FFT half-rotated energy path must equal the gather-trace kernel
    exactly (both are exact; ``ueg_kernels.pyx:77-133``)."""
    for nup, ndown, ecut in ((2, 2, 0.5), (7, 7, 1.0), (3, 1, 1.0)):
        ham = make_ueg(nup=nup, ndown=ndown, rs=1.2, ecut=ecut)
        trial = rhf_identity_trial(ham)
        rng = np.random.default_rng(4)
        nw = 3
        phi = rng.standard_normal((nw, ham.nbasis, nup + ndown)) + (
            1j * rng.standard_normal((nw, ham.nbasis, nup + ndown))
        )
        ga = greens.greens_function(jnp.asarray(phi[:, :, :nup]), trial.psia)
        gb = greens.greens_function(jnp.asarray(phi[:, :, nup:]), trial.psib)
        want = np.asarray(le.local_energy_ueg(ham, ga.G, gb.G))
        got = np.asarray(le.local_energy_ueg_half(
            ham, trial, ga.Ghalf, gb.Ghalf))
        np.testing.assert_allclose(got, want, rtol=1e-8, atol=1e-10)


@pytest.mark.unit
def test_ueg_fft_energy_nontrivial_trial():
    """Same check with a random (non-identity) single-det trial — the FFT
    path uses CT^dagger explicitly, so the half-rotation must not assume
    identity orbitals."""
    from pauxy_jax.models.trial import trial_from_orbitals

    ham = make_ueg(nup=3, ndown=3, rs=1.0, ecut=1.0)
    rng = np.random.default_rng(8)
    psi = np.linalg.qr(
        rng.standard_normal((ham.nbasis, 6))
        + 1j * rng.standard_normal((ham.nbasis, 6))
    )[0]
    trial = trial_from_orbitals(ham, psi)
    nw = 2
    phi = rng.standard_normal((nw, ham.nbasis, 6)) + 1j * rng.standard_normal(
        (nw, ham.nbasis, 6)
    )
    ga = greens.greens_function(jnp.asarray(phi[:, :, :3]), trial.psia)
    gb = greens.greens_function(jnp.asarray(phi[:, :, 3:]), trial.psib)
    want = np.asarray(le.local_energy_ueg(ham, ga.G, gb.G))
    got = np.asarray(le.local_energy_ueg_half(ham, trial, ga.Ghalf, gb.Ghalf))
    np.testing.assert_allclose(got, want, rtol=1e-8, atol=1e-10)


def test_structure_factor_fft_matches_gather():
    """The FFT pseudo-spectral S(k) (shared bra AND per-walker bra) must
    equal the gather-kernel S(k) on the same Green's functions
    (ueg_kernels.pyx:77-133 vs :42-75 equivalence)."""
    import jax
    import jax.numpy as jnp

    from pauxy_jax.estimators import local_energy as le
    from pauxy_jax.models import make_ueg, rhf_identity_trial
    from pauxy_jax.ops import greens as gops
    from pauxy_jax.walkers import init_walkers

    ham = make_ueg(nup=7, ndown=7, rs=1.0, ecut=1.0)
    trial = rhf_identity_trial(ham)
    state = init_walkers(trial, 3)
    key = jax.random.key(5)
    phia = state.phia + 0.05 * jax.random.normal(key, state.phia.shape)
    phib = state.phib + 0.05 * jax.random.normal(
        jax.random.fold_in(key, 1), state.phib.shape
    )

    # Shared trial bra.
    ga = gops.greens_function(phia, trial.psia)
    gb = gops.greens_function(phib, trial.psib)
    sk_fft = jax.jit(le.structure_factor_ueg, static_argnums=())(
        ham, ((trial.psia, ga.Ghalf), (trial.psib, gb.Ghalf))
    )
    sk_gather = le.structure_factor_ueg(ham, ((ga.G, None), (gb.G, None)))
    np.testing.assert_allclose(np.asarray(sk_fft), np.asarray(sk_gather),
                               atol=1e-10)

    # Per-walker bra (the BP case): bra = phi_bp, ket = phi_old.
    from pauxy_jax.estimators.back_prop import (bp_greens_function,
                                                bp_half_greens_function)

    bra_a = phia + 0.03 * jax.random.normal(jax.random.fold_in(key, 2),
                                            phia.shape)
    bra_b = phib + 0.03 * jax.random.normal(jax.random.fold_in(key, 3),
                                            phib.shape)
    ga_bp, gb_bp = bp_greens_function(bra_a, bra_b, phia, phib)
    gha = bp_half_greens_function(bra_a, phia)
    ghb = bp_half_greens_function(bra_b, phib)
    # gh really is the half factor of the BP G.
    np.testing.assert_allclose(
        np.asarray(jnp.einsum("wmi,win->wmn", bra_a.conj(), gha)),
        np.asarray(ga_bp), atol=1e-10,
    )
    sk_fft_bp = le.structure_factor_ueg(ham, ((bra_a, gha), (bra_b, ghb)))
    sk_gather_bp = le.structure_factor_ueg(
        ham, ((ga_bp, None), (gb_bp, None))
    )
    np.testing.assert_allclose(np.asarray(sk_fft_bp),
                               np.asarray(sk_gather_bp), atol=1e-10)
