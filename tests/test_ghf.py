"""GHF multi-determinant family vs dense numpy references.

Oracles: brute-force determinant algebra coded inline, and the reference's
``pauxy.estimators.hubbard.local_energy_hubbard_ghf``.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest

from pauxy_jax.models import make_hubbard, free_electron_trial
from pauxy_jax.models import ghf as ghf_mod

REFERENCE = "/root/reference"
HAVE_REF = os.path.isdir(os.path.join(REFERENCE, "pauxy"))
if HAVE_REF:
    sys.path.insert(0, REFERENCE)


def random_ghf_setup(seed=3, m=6, na=2, nb=2, nd=3, nw=4):
    """Random GHF trial (spin-mixing dets) + block-diagonal walkers."""
    rng = np.random.default_rng(seed)
    ne = na + nb
    psi = rng.standard_normal((nd, 2 * m, ne)) + 1j * rng.standard_normal(
        (nd, 2 * m, ne)
    )
    coeffs = rng.standard_normal(nd) + 1j * rng.standard_normal(nd)
    phia = rng.standard_normal((nw, m, na)) + 1j * rng.standard_normal(
        (nw, m, na)
    )
    phib = rng.standard_normal((nw, m, nb)) + 1j * rng.standard_normal(
        (nw, m, nb)
    )
    return psi, coeffs, phia, phib


def embed_block(phia, phib):
    """Block-diagonal 2M x ne walker from the (phia, phib) pair."""
    nw, m, na = phia.shape
    nb = phib.shape[2]
    phi = np.zeros((nw, 2 * m, na + nb), dtype=complex)
    phi[:, :m, :na] = phia
    phi[:, m:, na:] = phib
    return phi


def dense_trial(ham_like, psi, coeffs, phia, phib):
    from pauxy_jax.utils.transfer import to_device

    return ghf_mod.GHFTrial(
        psi=to_device(psi.astype(np.complex128)),
        coeffs=to_device(coeffs.astype(np.complex128)),
        inita=to_device(phia[0].astype(np.complex128)),
        initb=to_device(phib[0].astype(np.complex128)),
    )


@pytest.mark.unit
def test_ghf_overlap_and_greens_vs_dense():
    psi, coeffs, phia, phib = random_ghf_setup()
    trial = dense_trial(None, psi, coeffs, phia, phib)
    phi = embed_block(phia, phib)
    nw, nd = phia.shape[0], psi.shape[0]

    log_o = np.asarray(ghf_mod.ghf_log_overlap(
        trial, jnp.asarray(phia), jnp.asarray(phib)))
    gi, wts = ghf_mod.ghf_greens_function(
        trial, jnp.asarray(phia), jnp.asarray(phib))
    gi, wts = np.asarray(gi), np.asarray(wts)

    for w in range(nw):
        dets = np.array(
            [np.linalg.det(psi[d].conj().T @ phi[w]) for d in range(nd)]
        )
        ot = np.sum(coeffs.conj() * dets)
        np.testing.assert_allclose(np.exp(log_o[w]), ot, rtol=1e-9)
        wts_ref = coeffs.conj() * dets / ot
        np.testing.assert_allclose(wts[w], wts_ref, rtol=1e-9)
        for d in range(nd):
            s = psi[d].conj().T @ phi[w]
            gi_ref = (phi[w] @ np.linalg.inv(s) @ psi[d].conj().T).T
            np.testing.assert_allclose(gi[w, d], gi_ref, rtol=1e-8, atol=1e-10)


@pytest.mark.unit
def test_ghf_site_ratio_vs_brute_force():
    """The sweep's joint two-row det ratio must equal brute-force
    det(S')/det(S) for both field choices at every site."""
    psi, coeffs, phia, phib = random_ghf_setup(seed=7, nw=2)
    phi = embed_block(phia, phib)
    m, na = phia.shape[1], phia.shape[2]
    nd = psi.shape[0]
    delta = np.array([[0.3 + 0.1j, -0.2], [-0.4, 0.5 - 0.2j]])

    gi_all, _ = ghf_mod.ghf_greens_function(
        dense_trial(None, psi, coeffs, phia, phib),
        jnp.asarray(phia), jnp.asarray(phib))
    gi_all = np.asarray(gi_all)

    for w in range(2):
        for i in (0, m // 2, m - 1):
            for d in range(nd):
                g = gi_all[w, d]
                guu, gdd = g[i, i], g[i + m, i + m]
                gud, gdu = g[i, i + m], g[i + m, i]
                for x in (0, 1):
                    r_formula = (
                        (1 + delta[x, 0] * guu) * (1 + delta[x, 1] * gdd)
                        - delta[x, 0] * gud * delta[x, 1] * gdu
                    )
                    phi2 = phi[w].copy()
                    phi2[i, :na] *= 1 + delta[x, 0]
                    phi2[i + m, na:] *= 1 + delta[x, 1]
                    s_old = psi[d].conj().T @ phi[w]
                    s_new = psi[d].conj().T @ phi2
                    r_brute = np.linalg.det(s_new) / np.linalg.det(s_old)
                    np.testing.assert_allclose(r_formula, r_brute, rtol=1e-8)


@pytest.mark.unit
def test_ghf_local_energy_vs_reference():
    if not HAVE_REF:
        pytest.skip("no reference")
    from pauxy.estimators.hubbard import local_energy_hubbard_ghf

    ham = make_hubbard(nup=2, ndown=2, U=4.0, nx=2, ny=3)
    psi, coeffs, phia, phib = random_ghf_setup(
        seed=5, m=ham.nbasis, na=2, nb=2, nd=2, nw=3
    )
    trial = dense_trial(ham, psi, coeffs, phia, phib)
    gi, wts = ghf_mod.ghf_greens_function(
        trial, jnp.asarray(phia), jnp.asarray(phib))
    from pauxy_jax.estimators import local_energy as le

    etot, ke, pe = le.local_energy_hubbard_ghf(ham, gi, wts)
    etot, ke, pe = np.asarray(etot), np.asarray(ke), np.asarray(pe)

    phi = embed_block(phia, phib)
    t = np.asarray(ham.T[0])

    class RefSys:
        pass

    sys_ = RefSys()
    sys_.nbasis = ham.nbasis
    sys_.U = ham.U
    sys_.Text = np.block(
        [[t, np.zeros_like(t)], [np.zeros_like(t), t]]
    )
    for w in range(3):
        dets = np.array(
            [np.linalg.det(psi[d].conj().T @ phi[w]) for d in range(2)]
        )
        weights_ref = coeffs.conj() * dets
        gi_ref = np.asarray(gi[w])
        e_ref = local_energy_hubbard_ghf(
            sys_, gi_ref, weights_ref, weights_ref.sum()
        )
        np.testing.assert_allclose(etot[w], e_ref[0], rtol=1e-7)
        np.testing.assert_allclose(ke[w], e_ref[1], rtol=1e-7)
        np.testing.assert_allclose(pe[w], e_ref[2], rtol=1e-7)


@pytest.mark.unit
def test_ghf_sweep_overlap_consistency():
    """After a full Hirsch GHF sweep, the maintained log_ovlp must equal the
    from-scratch GHF overlap of the updated walkers."""
    import jax
    from pauxy_jax.propagation.hirsch import make_hirsch
    from pauxy_jax.walkers.state import init_walkers

    ham = make_hubbard(nup=2, ndown=2, U=4.0, nx=2, ny=2)
    fe = free_electron_trial(ham)
    psia = np.asarray(fe.psia)
    psib = np.asarray(fe.psib)
    # Two-det GHF trial: the UHF embedding plus a randomly rotated copy.
    rng = np.random.default_rng(11)
    m, na, nb = ham.nbasis, 2, 2
    psi = np.zeros((2, 2 * m, na + nb), dtype=complex)
    psi[0, :m, :na] = psia
    psi[0, m:, na:] = psib
    psi[1] = psi[0] + 0.2 * (
        rng.standard_normal((2 * m, na + nb))
        + 1j * rng.standard_normal((2 * m, na + nb))
    )
    trial = ghf_mod.make_ghf_trial(ham, psi, np.array([0.8, 0.2]),
                                   init=(psia, psib))
    prop = make_hirsch(ham, trial, dt=0.05)
    state = init_walkers(trial, 6)
    new, fields = prop._site_sweep_ghf(trial, state, jax.random.key(2))
    assert np.isfinite(np.asarray(new.weight)).all()
    assert np.asarray(new.weight).min() > 0
    log_scratch = np.asarray(
        ghf_mod.ghf_log_overlap(trial, new.phia, new.phib)
    )
    log_maintained = np.asarray(new.log_ovlp)
    # Compare modulo 2 pi i branch.
    np.testing.assert_allclose(
        np.exp(log_maintained - log_scratch), 1.0 + 0j, rtol=1e-5
    )


@pytest.mark.driver
def test_ghf_driver_matches_uhf_single_det(tmp_path):
    """A single-det GHF trial embedding the UHF pair must give the SAME
    physics as the plain single-det walker path (identical RNG stream)."""
    from pauxy_jax.qmc import AFQMC, QMCOpts

    ham = make_hubbard(nup=3, ndown=3, U=4.0, nx=3, ny=3)
    fe = free_electron_trial(ham)
    psia, psib = np.asarray(fe.psia), np.asarray(fe.psib)
    ghf = ghf_mod.ghf_trial_from_uhf(ham, psia, psib)
    assert ghf.etrial == pytest.approx(fe.etrial, abs=1e-4)

    qmc = QMCOpts(nwalkers=10, dt=0.05, nsteps=5, nblocks=4, nstblz=5,
                  npop_control=5, rng_seed=8)
    rows = {}
    for tag, trial in (("uhf", fe), ("ghf", ghf)):
        popts = {"hubbard_stratonovich": "discrete"}
        af = AFQMC(ham, trial, qmc, propagator_options=popts,
                   estimator_options={"mixed": {"energy_eval_freq": 1}},
                   filename=str(tmp_path / f"{tag}.h5"))
        rows[tag] = af.run()
    et_u = rows["uhf"][:, 5].real
    et_g = rows["ghf"][:, 5].real
    assert np.isfinite(et_g).all()
    # Same seed, same fields sampled per site: identical trajectories.
    np.testing.assert_allclose(et_g, et_u, rtol=5e-4)


@pytest.mark.unit
def test_ghf_variational_energy_vs_rayleigh_quotient():
    """GAB-full GHF variational energy vs the Rayleigh quotient from the
    non-orthogonal (H, S) matrices, for spin-block determinants where both
    machineries apply (``pauxy/estimators/hubbard.py:145-176``)."""
    from pauxy_jax.estimators import local_energy as le
    from pauxy_jax.models.ghf import ghf_variational_energy
    from pauxy_jax.models.trial import trial_density_matrix

    ham = make_hubbard(nup=2, ndown=2, U=4.0, nx=2, ny=2)
    m, na = ham.nbasis, 2
    rng = np.random.default_rng(3)
    # Two random block-diagonal dets (spin-conserving).
    dets = []
    for _ in range(2):
        pa = np.linalg.qr(rng.standard_normal((m, na)))[0]
        pb = np.linalg.qr(rng.standard_normal((m, na)))[0]
        d = np.zeros((2 * m, 2 * na), dtype=complex)
        d[:m, :na] = pa
        d[m:, na:] = pb
        dets.append((d, pa, pb))
    coeffs = np.array([0.7, 0.3 + 0.2j])

    e_ghf = ghf_variational_energy(ham, np.stack([d for d, _, _ in dets]),
                                   coeffs)

    # Independent Rayleigh quotient via spin-block transition densities.
    h = np.zeros((2, 2), dtype=complex)
    s = np.zeros((2, 2), dtype=complex)
    for i, (_, pia, pib) in enumerate(dets):
        for j, (_, pja, pjb) in enumerate(dets):
            oa = pia.conj().T @ pja
            ob = pib.conj().T @ pjb
            ovlp = np.linalg.det(oa) * np.linalg.det(ob)
            ga = np.conj(pja @ np.linalg.solve(oa, pia.conj().T)).T
            gb = np.conj(pjb @ np.linalg.solve(ob, pib.conj().T)).T
            etot = le.local_energy_G_host(ham, np.stack([ga, gb]))[0]
            h[i, j] = ovlp * etot
            s[i, j] = ovlp
    c = coeffs
    e_rq = float(np.real((c.conj() @ h @ c) / (c.conj() @ s @ c)))
    assert e_ghf == pytest.approx(e_rq, abs=1e-10)

    # Single-det embedding reduces to the UHF variational energy.
    d0, pa, pb = dets[0]
    g = trial_density_matrix(pa.astype(complex), pb.astype(complex))
    e_uhf = float(np.real(le.local_energy_G_host(ham, g)[0]))
    assert ghf_variational_energy(ham, d0[None], np.ones(1)) == pytest.approx(
        e_uhf, abs=1e-10)
