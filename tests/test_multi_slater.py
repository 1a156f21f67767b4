"""Multi-determinant (NOMSD) trial tests."""

import numpy as np
import jax.numpy as jnp
import pytest

from pauxy_jax.models import make_hubbard, make_generic
from pauxy_jax.models.multi_slater import (
    MultiSlaterTrial,
    greens_function_multi_det,
    log_overlap_multi_det,
    multi_slater_trial,
)
from pauxy_jax.qmc import AFQMC, QMCOpts
from pauxy_jax.utils.testing import generate_hamiltonian, random_wavefunction


def build_msd(ham, ndets=3, seed=2):
    rng = np.random.default_rng(seed)
    m, na, nb = ham.nbasis, ham.nup, ham.ndown
    psi = rng.standard_normal((ndets, m, na + nb)) + 1j * rng.standard_normal(
        (ndets, m, na + nb)
    )
    coeffs = rng.standard_normal(ndets) + 1j * rng.standard_normal(ndets)
    return multi_slater_trial(ham, psi, coeffs)


@pytest.mark.unit
def test_msd_overlap_and_greens_vs_numpy():
    ham = make_hubbard(nup=3, ndown=3, U=4.0, nx=3, ny=3)
    trial = build_msd(ham)
    rng = np.random.default_rng(7)
    nw, m, na = 2, 9, 3
    phi = rng.standard_normal((nw, m, 6)) + 1j * rng.standard_normal((nw, m, 6))
    phia, phib = jnp.asarray(phi[:, :, :3]), jnp.asarray(phi[:, :, 3:])

    md = greens_function_multi_det(trial, phia, phib)
    lo = log_overlap_multi_det(trial, phia, phib)

    psia = np.asarray(trial.psia)
    psib = np.asarray(trial.psib)
    coeffs = np.asarray(trial.coeffs)
    for w in range(nw):
        dets, gs = [], []
        for d in range(3):
            sa = phi[w, :, :3].T @ psia[d].conj()
            sb = phi[w, :, 3:].T @ psib[d].conj()
            det = np.linalg.det(sa) * np.linalg.det(sb)
            ga = psia[d].conj() @ np.linalg.inv(sa) @ phi[w, :, :3].T
            gb = psib[d].conj() @ np.linalg.inv(sb) @ phi[w, :, 3:].T
            dets.append(coeffs[d].conj() * det)
            gs.append(np.stack([ga, gb]))
        ovlp = sum(dets)
        g_ref = sum(dd * gg for dd, gg in zip(dets, gs)) / ovlp
        np.testing.assert_allclose(np.exp(complex(lo[w])), ovlp, rtol=1e-8)
        np.testing.assert_allclose(np.exp(complex(md.log_ovlp[w])), ovlp,
                                   rtol=1e-8)
        np.testing.assert_allclose(np.asarray(md.G[w]), g_ref, atol=1e-9)
        w_ref = np.array(dets) / ovlp
        np.testing.assert_allclose(np.asarray(md.det_weights[w]), w_ref,
                                   atol=1e-9)


@pytest.mark.unit
def test_msd_single_det_limit():
    """ndets=1 must reproduce the single-determinant machinery exactly."""
    from pauxy_jax.models.trial import trial_from_orbitals
    from pauxy_jax.ops import greens

    ham = make_hubbard(nup=3, ndown=3, U=4.0, nx=3, ny=3)
    rng = np.random.default_rng(3)
    psi = rng.standard_normal((9, 6)) + 1j * rng.standard_normal((9, 6))
    msd = multi_slater_trial(ham, psi[None], np.ones(1))
    sd = trial_from_orbitals(ham, psi)
    phi = rng.standard_normal((3, 9, 6)) + 1j * rng.standard_normal((3, 9, 6))
    phia, phib = jnp.asarray(phi[:, :, :3]), jnp.asarray(phi[:, :, 3:])
    md = greens_function_multi_det(msd, phia, phib)
    ga = greens.greens_function(phia, sd.psia)
    gb = greens.greens_function(phib, sd.psib)
    np.testing.assert_allclose(np.asarray(md.G[:, 0]), np.asarray(ga.G),
                               atol=1e-9)
    ratio = np.asarray(md.log_ovlp - (ga.log_ovlp + gb.log_ovlp))
    np.testing.assert_allclose(ratio.real, 0, atol=1e-9)


@pytest.mark.driver
def test_msd_afqmc_hubbard(tmp_path):
    """Phaseless run with a 2-determinant trial on 3x3 Hubbard."""
    ham = make_hubbard(nup=3, ndown=3, U=4.0, nx=3, ny=3)
    # Two UHF-ish determinants: free-electron + slightly rotated copy.
    from pauxy_jax.models.trial import free_electron_trial

    fe = free_electron_trial(ham)
    base = np.concatenate(
        [np.asarray(fe.psia), np.asarray(fe.psib)], axis=1
    )
    rng = np.random.default_rng(5)
    pert = base + 0.05 * rng.standard_normal(base.shape)
    trial = multi_slater_trial(ham, np.stack([base, pert]),
                               np.array([0.9, 0.1]))
    qmc = QMCOpts(nwalkers=12, dt=0.01, nsteps=10, nblocks=5, nstblz=5,
                  npop_control=5, rng_seed=8)
    af = AFQMC(ham, trial, qmc,
               estimator_options={"mixed": {"energy_eval_freq": 1}},
               filename=str(tmp_path / "msd.h5"))
    rows = af.run()
    assert np.isfinite(rows.real).all()
    # Energy comparable to the single-det run (same physics).
    assert -12 < rows[-1, 5].real < -5


@pytest.mark.driver
def test_msd_afqmc_generic(tmp_path):
    h1e, chol, enuc, _ = generate_hamiltonian(6, (2, 2), seed=31)
    ham = make_generic((2, 2), h1e, chol, enuc)
    rng = np.random.default_rng(17)
    eye = np.eye(6)[:, :4]
    psi = np.stack([eye, eye + 0.05 * rng.standard_normal(eye.shape)])
    trial = multi_slater_trial(ham, psi, np.array([0.95, 0.05]))
    qmc = QMCOpts(nwalkers=8, dt=0.005, nsteps=10, nblocks=3, nstblz=5,
                  npop_control=5, rng_seed=8)
    af = AFQMC(ham, trial, qmc,
               estimator_options={"mixed": {"energy_eval_freq": 1}},
               filename=str(tmp_path / "msdg.h5"))
    rows = af.run()
    assert np.isfinite(rows.real).all()


@pytest.mark.unit
def test_singular_det_overlap_is_sanitised():
    """A walker exactly orthogonal to one determinant must give finite
    G / weights (PHMSD identity-column dets hit this at init)."""
    import jax

    from pauxy_jax.models.multi_slater import (greens_function_multi_det,
                                               phmsd_trial)
    from pauxy_jax.walkers import init_walkers

    ham = make_hubbard(nup=2, ndown=2, U=4.0, nx=4, ny=1)
    trial = phmsd_trial(ham, coeffs=[0.95, 0.05],
                        occa=[(0, 1), (0, 2)], occb=[(0, 1), (0, 1)])
    # Force the pathological start: walkers = first determinant exactly.
    state = init_walkers(trial, 4)
    state = state.replace(
        phia=jnp.broadcast_to(trial.psia[0], state.phia.shape),
        phib=jnp.broadcast_to(trial.psib[0], state.phib.shape),
    )
    md = greens_function_multi_det(trial, state.phia, state.phib)
    assert bool(jnp.isfinite(md.G).all())
    assert bool(jnp.isfinite(md.log_ovlp.real).all())
    # Default init avoids the degeneracy entirely: every det overlaps.
    md2 = greens_function_multi_det(
        trial,
        jnp.asarray(trial.inita)[None],
        jnp.asarray(trial.initb)[None],
    )
    assert bool(jnp.isfinite(md2.G).all())
    w = np.asarray(md2.det_weights)
    assert np.abs(w).min() > 0


@pytest.mark.unit
def test_single_det_msd_matches_single_det_driver(tmp_path, monkeypatch):
    """D=1 NOMSD through the full driver reproduces the single-det result
    bit-for-bit (same RNG stream, same math)."""
    import os

    from pauxy_jax.models import free_electron_trial
    from pauxy_jax.models.multi_slater import multi_slater_trial
    from pauxy_jax.qmc import AFQMC, QMCOpts

    monkeypatch.chdir(tmp_path)
    ham = make_hubbard(nup=3, ndown=3, U=4.0, nx=3, ny=3,
                       ktwist=[0.01, -0.02])
    tr1 = free_electron_trial(ham)
    psi = np.concatenate([np.asarray(tr1.psia), np.asarray(tr1.psib)], axis=1)
    trm = multi_slater_trial(ham, psi[None], coeffs=[1.0])
    qmc = QMCOpts(nwalkers=12, dt=0.05, nsteps=5, nblocks=2, nstblz=5,
                  npop_control=5, rng_seed=9)
    out = {}
    for tag, tr in (("single", tr1), ("msd1", trm)):
        af = AFQMC(ham, tr, qmc,
                   estimator_options={"mixed": {"energy_eval_freq": 1}},
                   filename=str(tmp_path / f"est_{tag}.h5"))
        out[tag] = np.asarray(af.run())[:, 5].real
    np.testing.assert_allclose(out["single"], out["msd1"], atol=1e-12)


@pytest.mark.unit
def test_msd_half_rotated_energy_vs_dense():
    """The per-determinant half-rotated fast energy kernel
    (local_energy_generic_opt_multi) equals the dense per-det cholesky
    energy, det-averaged — and the MSD force bias from per-det rchol equals
    the full-G contraction."""
    from pauxy_jax.estimators import local_energy as le
    from pauxy_jax.propagation.continuous import trial_greens
    from pauxy_jax.propagation.generic import make_generic_continuous

    rng = np.random.default_rng(7)
    nmo, na, nb, nchol, ndets, nw = 9, 3, 3, 18, 4, 5
    h1e, chol, enuc, _ = generate_hamiltonian(nmo, (na, nb), seed=7)
    ham = make_generic((na, nb), h1e, chol, enuc)
    psi = rng.standard_normal((ndets, nmo, na + nb)) + 0.1j * (
        rng.standard_normal((ndets, nmo, na + nb))
    )
    coeffs = rng.standard_normal(ndets) + 0.1j * rng.standard_normal(ndets)
    trial = multi_slater_trial(ham, psi, coeffs)
    assert trial.rchola is not None and trial.rchola.ndim == 4

    phia = jnp.asarray(
        rng.standard_normal((nw, nmo, na))
        + 0.1j * rng.standard_normal((nw, nmo, na))
    )
    phib = jnp.asarray(
        rng.standard_normal((nw, nmo, nb))
        + 0.1j * rng.standard_normal((nw, nmo, nb))
    )
    md = greens_function_multi_det(trial, phia, phib)
    etf, _, _ = le.local_energy_generic_opt_multi(
        trial, md.Ghalfa, md.Ghalfb, md.det_weights, ham.ecore
    )
    # dense per-det reference
    h1 = np.asarray(ham.H1)
    chold = np.asarray(ham.chol)
    gi, wd = np.asarray(md.Gi), np.asarray(md.det_weights)
    etd = np.zeros(nw, complex)
    for w in range(nw):
        for d in range(ndets):
            ga, gb = gi[w, d, 0], gi[w, d, 1]
            e1 = np.einsum("mn,mn->", h1[0], ga) + np.einsum(
                "mn,mn->", h1[1], gb
            )
            x = np.einsum("ikx,ik->x", chold, ga + gb)
            exx = 0.0
            for g in (ga, gb):
                t = np.einsum("il,ikx->lkx", g, chold)
                exx += np.einsum("lkx,klx->", t, t)
            etd[w] += wd[w, d] * (e1 + 0.5 * (x @ x - exx) + ham.ecore)
    np.testing.assert_allclose(np.asarray(etf), etd, atol=1e-11)

    inner = make_generic_continuous(ham, trial, 0.01)
    ga, gb, _ = trial_greens(trial, phia, phib)
    fb_fast = np.asarray(inner.force_bias(trial, ga, gb))
    fb_slow = np.asarray(
        inner.force_bias(trial, ga._replace(Ghalf=None),
                         gb._replace(Ghalf=None))
    )
    np.testing.assert_allclose(fb_fast, fb_slow, atol=1e-12)


@pytest.mark.unit
def test_recompute_ci_coeffs_full_space_is_fci():
    """Rediagonalizing over the COMPLETE orthogonal determinant basis must
    reproduce the FCI ground state (``multi_slater.py:193-232``)."""
    import itertools

    from pauxy_jax.estimators import ci
    from pauxy_jax.models.generic import make_generic
    from pauxy_jax.models.multi_slater import recompute_ci_coeffs

    rng = np.random.default_rng(1)
    nmo, na = 4, 2
    chol = rng.normal(scale=0.2, size=(nmo, nmo, 7))
    chol = 0.5 * (chol + chol.transpose(1, 0, 2))
    h1 = rng.normal(scale=0.4, size=(nmo, nmo))
    h1 = 0.5 * (h1 + h1.T)
    ham = make_generic((na, na), np.stack([h1, h1]), chol, ecore=0.17)
    e_fci, _, _ = ci.simple_fci(ham)

    occa, occb = [], []
    for oa in itertools.combinations(range(nmo), na):
        for ob in itertools.combinations(range(nmo), na):
            occa.append(oa)
            occb.append(ob)
    coeffs, e0 = recompute_ci_coeffs(ham, occa=occa, occb=occb)
    assert e0 == pytest.approx(float(e_fci[0]), abs=1e-8)
    assert np.isfinite(coeffs).all()


@pytest.mark.unit
def test_recompute_ci_coeffs_nonorthogonal():
    """Non-orthogonal two-det expansion: rediagonalized energy is below
    both single-det variational energies (generalized eigenproblem)."""
    from pauxy_jax.estimators import local_energy as le
    from pauxy_jax.models.generic import make_generic
    from pauxy_jax.models.multi_slater import recompute_ci_coeffs
    from pauxy_jax.models.trial import trial_density_matrix

    rng = np.random.default_rng(5)
    nmo, na = 4, 2
    chol = rng.normal(scale=0.2, size=(nmo, nmo, 7))
    chol = 0.5 * (chol + chol.transpose(1, 0, 2))
    h1 = rng.normal(scale=0.4, size=(nmo, nmo))
    h1 = 0.5 * (h1 + h1.T)
    ham = make_generic((na, na), np.stack([h1, h1]), chol, ecore=0.0)

    def evar(psi):
        g = trial_density_matrix(psi[:, :na], psi[:, na:])
        return float(np.real(le.local_energy_G_host(ham, g)[0]))

    d1 = np.linalg.qr(rng.standard_normal((nmo, 2 * na)))[0]
    d2 = np.linalg.qr(rng.standard_normal((nmo, 2 * na)))[0]
    coeffs, e0 = recompute_ci_coeffs(ham, np.stack([d1, d2]), na)
    assert e0 <= min(evar(d1), evar(d2)) + 1e-10
