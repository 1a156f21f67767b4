"""Hubbard-Holstein model tests."""

import numpy as np
import pytest

from pauxy_jax.models.hubbard_holstein import (
    coherent_state_trial,
    make_hubbard_holstein,
)
from pauxy_jax.qmc import AFQMC, QMCOpts


@pytest.mark.unit
def test_system_params_vs_reference():
    import os, sys

    if not os.path.isdir("/root/reference/pauxy"):
        pytest.skip("no reference")
    sys.path.insert(0, "/root/reference")
    from pauxy.systems.hubbard_holstein import HubbardHolstein as Ref

    ref = Ref({"nx": 4, "ny": 1, "nup": 2, "ndown": 2, "U": 4.0,
               "w0": 0.8, "lambda": 0.5, "ktwist": [0.0]})
    ham = make_hubbard_holstein(nup=2, ndown=2, U=4.0, nx=4, w0=0.8,
                                lmbda=0.5)
    assert ham.g == pytest.approx(ref.g)
    assert ham.m == pytest.approx(ref.m)
    np.testing.assert_allclose(np.asarray(ham.T), np.asarray(ref.T).real,
                               atol=1e-12)


@pytest.mark.unit
def test_coherent_state_trial_shift():
    """Shift satisfies the stationarity condition X = cpl rho / (m w0^2)."""
    ham = make_hubbard_holstein(nup=2, ndown=2, U=1.0, nx=4, w0=1.0,
                                lmbda=0.3)
    trial = coherent_state_trial(ham)
    psia = np.asarray(trial.psia)
    psib = np.asarray(trial.psib)
    rho = (np.einsum("mi,mi->m", psia, psia.conj())
           + np.einsum("mi,mi->m", psib, psib.conj())).real
    expected = ham.gsq2mw * rho / (ham.m * ham.w0 ** 2)
    np.testing.assert_allclose(np.asarray(trial.shift), expected, atol=1e-6)
    # Variational energy below the g=0 mean-field energy (polaron binding).
    assert trial.etrial < 0.0


@pytest.mark.driver
def test_single_site_polaron_exact(tmp_path):
    """One site, (1,1): exact E = U - 4 g^2/w0 (displaced-oscillator
    solution; the ZPE is excluded by the reference's convention)."""
    ham = make_hubbard_holstein(nup=1, ndown=1, U=4.0, nx=1, g=0.5, w0=1.0,
                                xpbc=False)
    trial = coherent_state_trial(ham)
    qmc = QMCOpts(nwalkers=200, dt=0.01, nsteps=20, nblocks=8, nstblz=10,
                  npop_control=10, rng_seed=7)
    af = AFQMC(ham, trial, qmc,
               estimator_options={"mixed": {"energy_eval_freq": 2}},
               filename=str(tmp_path / "pol.h5"))
    rows = af.run()
    exact = 4.0 - 4 * 0.5 ** 2 / 1.0
    et = rows[3:, 5].real
    assert abs(et.mean() - exact) < 0.05, (et.mean(), exact)


@pytest.mark.driver
def test_hh_g0_matches_hubbard(tmp_path):
    """g=0 decouples the phonons: electronic energy must agree with the
    plain Hubbard discrete run, and the phonon contribution vanishes
    on average."""
    hh = make_hubbard_holstein(nup=2, ndown=2, U=4.0, nx=4, g=0.0, w0=1.0,
                               xpbc=False)
    trial = coherent_state_trial(hh)
    qmc = QMCOpts(nwalkers=100, dt=0.01, nsteps=20, nblocks=12, nstblz=5,
                  npop_control=5, rng_seed=5)
    af = AFQMC(hh, trial, qmc,
               estimator_options={"mixed": {"energy_eval_freq": 2}},
               filename=str(tmp_path / "hh0.h5"))
    rows = af.run()
    assert np.isfinite(rows.real).all()

    from pauxy_jax.estimators import ci
    from pauxy_jax.models import make_hubbard

    hub = make_hubbard(nup=2, ndown=2, U=4.0, nx=4, xpbc=False)
    e_fci, _, _ = ci.simple_fci(hub)
    et = rows[6:, 5].real.mean()
    # CPMC on 4-site chain with this trial: close to the FCI electronic
    # energy (loose window; short run, constrained-path bias).
    assert abs(et - e_fci[0]) < 0.3, (et, e_fci[0])


@pytest.mark.unit
def test_lang_firsov_exact_limits():
    """LF is exact for the single-site (bi)polaron: one electron gives
    E = -g^2/w0, two give U - 4 g^2/w0 (lang_firsov.py:47-126 objective)."""
    from pauxy_jax.models.hubbard_holstein import (lang_firsov_energy,
                                                   lang_firsov_trial,
                                                   _lf_params)

    g, w0, u = 0.5, 1.25, 4.0
    ham2 = make_hubbard_holstein(nup=1, ndown=1, U=u, nx=1, g=g, w0=w0)
    gamma, ueff = _lf_params(ham2)
    psi = np.ones((1, 1), dtype=complex)
    e2 = lang_firsov_energy(ham2, psi, psi, gamma)
    assert e2 == pytest.approx(u - 4 * g ** 2 / w0, abs=1e-12)
    # Ueff at the standard gamma is U - 2 g^2/w0 (polaron-reduced repulsion).
    assert ueff == pytest.approx(u - 2 * g ** 2 / w0, abs=1e-12)

    ham1 = make_hubbard_holstein(nup=1, ndown=0, U=u, nx=1, g=g, w0=w0)
    e1 = lang_firsov_energy(ham1, psi, np.zeros((1, 0), dtype=complex), gamma)
    assert e1 == pytest.approx(-g ** 2 / w0, abs=1e-12)


@pytest.mark.unit
def test_lang_firsov_trial_variational():
    """Orbital relaxation only lowers the LF energy; relax_gamma lowers it
    further; both stay above the coherent-state+LF lower spread."""
    from pauxy_jax.models.hubbard_holstein import lang_firsov_trial

    ham = make_hubbard_holstein(nup=2, ndown=2, U=4.0, nx=4, w0=1.0,
                                lmbda=0.5)
    tr, gamma = lang_firsov_trial(ham)
    tr_rel, gamma_rel = lang_firsov_trial(ham, relax_gamma=True)
    assert tr_rel.etrial <= tr.etrial + 1e-8
    assert tr.name == "lang_firsov"
    assert np.allclose(np.asarray(tr.shift), 0.0)
    # Orbitals orthonormal.
    psia = np.asarray(tr.psia)
    np.testing.assert_allclose(psia.conj().T @ psia, np.eye(2), atol=1e-8)


@pytest.mark.driver
def test_lang_firsov_driver_runs(tmp_path, monkeypatch):
    """LF trial + lang_firsov propagator (Ueff Hirsch tables) through the
    full JSON-driven path stays finite."""
    from pauxy_jax.qmc.calc import setup_calculation

    monkeypatch.chdir(tmp_path)
    drv = setup_calculation({
        "model": {"name": "HubbardHolstein", "nx": 4, "ny": 1, "nup": 2,
                  "ndown": 2, "U": 4.0, "w0": 1.0, "lambda": 0.25},
        "qmc": {"nwalkers": 16, "timestep": 0.01, "num_steps": 5,
                "blocks": 3, "rng_seed": 2, "pop_control_freq": 5,
                "stabilise_freq": 5},
        "trial": {"name": "lang_firsov"},
        "propagator": {"lang_firsov": True},
        "estimators": {"filename": str(tmp_path / "lf.h5"),
                       "mixed": {"energy_eval_freq": 5}},
        "verbosity": 0,
    })
    assert drv.trial.name == "lang_firsov"
    rows = drv.run()
    w = np.asarray(rows)[:, 4].real
    assert np.isfinite(np.asarray(rows)).all()
    assert (w > 0).all()


@pytest.mark.driver
def test_multi_coherent_single_component_matches_coherent(tmp_path):
    """A 1-component multi-coherent trial must reproduce the single
    coherent-state walker path EXACTLY (identical RNG stream; the mixture
    collapses to the plain fermionic ratio + single-shift drift)."""
    from pauxy_jax.models.multi_coherent import multi_coherent_trial
    from pauxy_jax.utils.transfer import to_host

    ham = make_hubbard_holstein(nup=2, ndown=2, U=4.0, nx=4, g=0.4, w0=1.0,
                                xpbc=True)
    single = coherent_state_trial(ham)
    psia = np.asarray(to_host(single.psia))
    psib = np.asarray(to_host(single.psib))
    shift0 = np.asarray(to_host(single.shift)).real
    psi0 = np.concatenate([psia, psib], axis=1)
    mc = multi_coherent_trial(ham, psi_stack=psi0[None],
                              shift_stack=shift0[None], coeffs=np.ones(1))

    qmc = QMCOpts(nwalkers=20, dt=0.01, nsteps=10, nblocks=4, nstblz=5,
                  npop_control=5, rng_seed=7)
    rows = {}
    for tag, trial in (("single", single), ("multi", mc)):
        af = AFQMC(ham, trial, qmc,
                   estimator_options={"mixed": {"energy_eval_freq": 1}},
                   filename=str(tmp_path / f"{tag}.h5"))
        rows[tag] = af.run()
    np.testing.assert_allclose(
        rows["multi"][:, 5].real, rows["single"][:, 5].real, rtol=5e-4
    )


@pytest.mark.driver
def test_multi_coherent_polaron_vs_bose_fermi_fci(tmp_path):
    """Translation-symmetrized multi-coherent trial (P = 3 components) on
    the 3-site Hubbard-Holstein ring vs the in-repo bose-fermi FCI oracle
    (VERDICT r1 item 9: polaron benchmark at ndet > 1)."""
    from pauxy_jax.estimators.ci import simple_fci_bose_fermi
    from pauxy_jax.models.multi_coherent import multi_coherent_trial

    ham = make_hubbard_holstein(nup=1, ndown=1, U=4.0, nx=3, ny=1,
                                w0=0.8, lmbda=0.5)
    e_fci, _, _ = simple_fci_bose_fermi(ham, nboson_max=12)

    trial = multi_coherent_trial(ham)
    assert trial.nperms == 3
    qmc = QMCOpts(nwalkers=100, dt=0.005, nsteps=20, nblocks=15, nstblz=5,
                  npop_control=5, rng_seed=7)
    af = AFQMC(ham, trial, qmc,
               estimator_options={"mixed": {"energy_eval_freq": 2}},
               filename=str(tmp_path / "mc.h5"))
    rows = af.run()
    et = rows[5:, 5].real
    assert np.isfinite(et).all()
    # CPMC with the symmetrized trial: within the constrained-path bias +
    # statistics window of the exact bose-fermi ground state.
    assert abs(et.mean() - e_fci[0]) < 0.2, (et.mean(), e_fci[0])


@pytest.mark.driver
def test_symmetric_trotter_polaron(tmp_path):
    """symmetric_trotter reorders the step as boson(dt/2) K U K boson(dt/2)
    (reference hubbard_holstein.py:419-429). The single-site polaron limit
    must still reproduce the exact displaced-oscillator energy."""
    ham = make_hubbard_holstein(nup=1, ndown=1, U=4.0, nx=1, g=0.5, w0=1.0,
                                xpbc=False)
    trial = coherent_state_trial(ham)
    qmc = QMCOpts(nwalkers=200, dt=0.01, nsteps=20, nblocks=8, nstblz=10,
                  npop_control=10, rng_seed=7)
    af = AFQMC(ham, trial, qmc,
               propagator_options={"symmetric_trotter": True},
               estimator_options={"mixed": {"energy_eval_freq": 2}},
               filename=str(tmp_path / "polsym.h5"))
    assert af.prop.symmetric_trotter
    rows = af.run()
    exact = 4.0 - 4 * 0.5 ** 2 / 1.0
    et = rows[3:, 5].real
    assert abs(et.mean() - exact) < 0.05, (et.mean(), exact)
