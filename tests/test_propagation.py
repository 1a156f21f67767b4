"""Propagation unit tests: one deterministic step vs a scalar numpy rewrite.

The numpy implementation below follows the equations of
``pauxy/propagation/continuous.py:113-292`` independently; the jax path must
agree to near machine precision when fed the same Gaussian fields.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg

from pauxy_jax.models import make_hubbard, free_electron_trial
from pauxy_jax.propagation import continuous
from pauxy_jax.propagation.hubbard import make_hubbard_continuous
from pauxy_jax.walkers import init_walkers


def setup_problem(nw=3, dt=0.05, charge=True):
    ham = make_hubbard(nup=3, ndown=3, U=4.0, nx=3, ny=3, ktwist=[0.01, -0.02])
    trial = free_electron_trial(ham)
    inner = make_hubbard_continuous(ham, trial, dt, charge_decomposition=charge)
    prop = continuous.Continuous(inner=inner, dt=dt)
    state = init_walkers(trial, nw)
    return ham, trial, inner, prop, state


def numpy_phaseless_step(ham, trial, inner, dt, phia, phib, xi, hybrid_old, eshift):
    """Scalar (single-walker) phaseless step in plain numpy."""
    psia, psib = np.asarray(trial.psia), np.asarray(trial.psib)
    bh1 = np.asarray(inner.BH1)
    mf = np.asarray(inner.mf_shift)
    sqrt_dt = dt ** 0.5
    iu = 1j * ham.U ** 0.5

    def ovlp(pa, pb):
        return np.linalg.det(pa.T @ psia.conj()) * np.linalg.det(pb.T @ psib.conj())

    def gdiag(p, psi):
        s = p.T @ psi.conj()
        g = psi.conj() @ np.linalg.inv(s) @ p.T
        return np.diagonal(g)

    o_old = ovlp(phia, phib)
    # force bias from current greens
    vbias = iu * (gdiag(phia, psia) + gdiag(phib, psib))
    xbar = -sqrt_dt * (vbias - mf)
    xbar = np.where(np.abs(xbar) > 1, xbar / np.abs(xbar), xbar)
    xs = xi - xbar
    cmf = -sqrt_dt * xs @ mf
    cfb = xi @ xbar - 0.5 * xbar @ xbar
    gauge = np.exp(sqrt_dt * iu * xs)
    phia = bh1[0] @ (np.diag(gauge) @ (bh1[0] @ phia))
    phib = bh1[1] @ (np.diag(gauge) @ (bh1[1] @ phib))
    o_new = ovlp(phia, phib)
    ehyb = -(np.log(o_new / o_old) + cfb + cmf) / dt
    # no bound while eshift == 0
    imp = np.exp(-dt * (0.5 * (ehyb + hybrid_old) - eshift))
    magn = abs(imp)
    dtheta = (-dt * ehyb - cfb).imag
    cos_fac = max(0, np.cos(dtheta))
    return phia, phib, magn * cos_fac, ehyb, o_new


@pytest.mark.unit
def test_phaseless_step_matches_numpy():
    ham, trial, inner, prop, state = setup_problem(nw=3)
    key = jax.random.key(12)
    nf = ham.nfields
    xi = np.asarray(
        jax.random.normal(key, (state.nwalkers, nf), dtype=jnp.float64)
    )
    new = continuous.propagate_phaseless(
        prop, trial, state, key, jnp.asarray(0.0 + 0j)
    )
    for w in range(state.nwalkers):
        pa, pb, wfac, ehyb, o_new = numpy_phaseless_step(
            ham,
            trial,
            inner,
            prop.dt,
            np.asarray(state.phia[w]),
            np.asarray(state.phib[w]),
            xi[w],
            complex(state.hybrid_energy[w]),
            0.0,
        )
        np.testing.assert_allclose(np.asarray(new.phia[w]), pa, atol=1e-10)
        np.testing.assert_allclose(np.asarray(new.phib[w]), pb, atol=1e-10)
        np.testing.assert_allclose(float(new.weight[w]), wfac, rtol=1e-9)
        # log-branch ambiguity: hybrid energies agree up to 2 pi/dt in Im.
        diff = complex(new.hybrid_energy[w]) - ehyb
        assert abs(diff.real) < 1e-8
        np.testing.assert_allclose(
            np.exp(complex(new.log_ovlp[w])), o_new, rtol=1e-8
        )


@pytest.mark.unit
def test_hybrid_bound_applied():
    ham, trial, inner, prop, state = setup_problem(nw=2, dt=0.05)
    ebound = (2.0 / prop.dt) ** 0.5
    ehyb = jnp.asarray([100.0 + 1j, -100.0 - 2j])
    eshift = jnp.asarray(-9.0 + 0j)
    out = np.asarray(continuous._bound_hybrid(ehyb, eshift, ebound))
    assert out[0].real == pytest.approx(-9.0 + ebound)
    assert out[1].real == pytest.approx(-9.0 - ebound)
    np.testing.assert_allclose(out.imag, [1.0, -2.0])
    # eshift ~ 0 disables the bound (continuous.py:202-207).
    out2 = np.asarray(continuous._bound_hybrid(ehyb, jnp.asarray(0.0 + 0j), ebound))
    np.testing.assert_allclose(out2, np.asarray(ehyb))


@pytest.mark.unit
def test_one_body_propagator_is_expm():
    ham, trial, inner, prop, state = setup_problem(dt=0.01)
    iu = 1j * ham.U ** 0.5
    h1 = np.asarray(ham.h1e_mod[0]) - iu * np.diag(np.asarray(inner.mf_shift))
    expected = scipy.linalg.expm(-0.005 * h1)
    np.testing.assert_allclose(np.asarray(inner.BH1[0]), expected, atol=1e-12)


@pytest.mark.unit
def test_free_projection_conserves_phase_magnitude():
    ham, trial, inner, prop, state = setup_problem(nw=4)
    prop = continuous.Continuous(
        inner=inner, dt=prop.dt, free_projection=True, force_bias=False
    )
    key = jax.random.key(0)
    new = continuous.propagate_free(prop, trial, state, key, jnp.asarray(0.0 + 0j))
    np.testing.assert_allclose(np.abs(np.asarray(new.phase)), 1.0, atol=1e-12)
    assert np.all(np.asarray(new.weight) > 0)


@pytest.mark.unit
def test_local_energy_weight_update_runs():
    """hybrid=False uses the local-energy importance function
    (continuous.py:294-318); weights stay positive and finite."""
    import jax

    ham, trial, inner, prop, state = setup_problem(nw=4, dt=0.01)
    prop_le = continuous.Continuous(inner=inner, dt=0.01, hybrid=False)
    new = prop_le.propagate(trial, state, jax.random.key(2),
                            jnp.asarray(0.0 + 0j), ham=ham)
    w = np.asarray(new.weight)
    assert np.all(np.isfinite(w)) and np.all(w > 0)
    # eloc recorded on the state for the next step's average.
    assert np.all(np.abs(np.asarray(new.eloc)) > 0)


@pytest.mark.unit
def test_phmsd_trial_runs():
    from pauxy_jax.models.multi_slater import phmsd_trial
    from pauxy_jax.models import make_hubbard

    ham = make_hubbard(nup=2, ndown=2, U=4.0, nx=4, ny=1)
    trial = phmsd_trial(
        ham, coeffs=[0.9, 0.3], occa=[(0, 1), (0, 2)], occb=[(0, 1), (0, 1)]
    )
    assert trial.ndets == 2
    psia = np.asarray(trial.psia)
    # Determinants select identity columns.
    np.testing.assert_allclose(psia[0], np.eye(4)[:, [0, 1]])
    np.testing.assert_allclose(psia[1], np.eye(4)[:, [0, 2]])


@pytest.mark.unit
def test_stochastic_ri_kinetic_unbiased():
    """The Rademacher-sketched one-body half-step
    (continuous._apply_bh1_stochastic) equals the exact B application in
    expectation: averaging over sketches converges to exp(-dt T/2) phi.
    Reference: pauxy/propagation/operations.py:54-90
    (kinetic_real_stochastic)."""
    ham, trial, inner, prop, state = setup_problem(nw=2, dt=0.05)
    exact_a, exact_b = continuous._apply_bh1(
        inner.BH1, state.phia, state.phib)
    nrep, ns = 400, 8
    acc = jnp.zeros_like(exact_a)

    @jax.jit
    def one(key):
        pa, _ = continuous._apply_bh1_stochastic(
            inner.BH1, state.phia, state.phib, key, ns)
        return pa

    keys = jax.random.split(jax.random.key(7), nrep)
    ref = np.asarray(exact_a)

    def err_at(upto, acc):
        for k in keys[upto[0]:upto[1]]:
            acc = acc + one(k)
        mean = np.asarray(acc) / upto[1]
        return np.abs(mean - ref).max() / np.abs(ref).max(), acc

    err100, acc = err_at((0, 100), acc)
    err400, _ = err_at((100, 400), acc)
    # Unbiased => MC error ~ 1/sqrt(nrep): 4x repeats should roughly halve
    # it; a biased sketch would plateau.
    assert err400 < 0.15, err400
    assert err400 < 0.75 * err100, (err100, err400)


@pytest.mark.unit
def test_stochastic_ri_full_step_runs_and_tracks_exact():
    """A phaseless step with stochastic_ri on produces finite positive
    weights, and with a large sketch (ns >> M) tracks the exact step's
    walkers closely."""
    ham, trial, inner, prop, state = setup_problem(nw=4, dt=0.01)
    key = jax.random.key(11)
    eshift = jnp.asarray(0.0 + 0j)
    prop_ri = continuous.Continuous(inner=inner, dt=0.01,
                                    stochastic_ri=True, ri_nsamples=4096)
    exact = prop.propagate(trial, state, key, eshift)
    # NOTE: prop_ri consumes an extra key split; trajectories only match
    # statistically. Check weights finite and wavefunction overlap high.
    sri = prop_ri.propagate(trial, state, key, eshift)
    w = np.asarray(sri.weight)
    assert np.all(np.isfinite(w)) and np.all(w > 0)
    pa_e = np.asarray(exact.phia)
    pa_s = np.asarray(sri.phia)
    # Per-walker subspace alignment: principal angles ~ 0 for ns >> M.
    for i in range(pa_e.shape[0]):
        qe, _ = np.linalg.qr(pa_e[i])
        qs, _ = np.linalg.qr(pa_s[i])
        sv = np.linalg.svd(qe.conj().T @ qs, compute_uv=False)
        assert sv.min() > 0.9, (i, sv)


@pytest.mark.unit
def test_spin_project_init():
    """spin_proj replaces the initial walker determinant with natural
    orbitals of the spin-summed trial projector (reference
    trial_wavefunction/utils.py:123-144); free-electron variant uses the
    one-body eigenvectors. The trial orbitals themselves are unchanged."""
    import numpy as np

    from pauxy_jax.models import make_hubbard
    from pauxy_jax.models.trial import (free_electron_trial,
                                        spin_project_init, uhf_trial)
    from pauxy_jax.utils.transfer import to_host

    ham = make_hubbard(nup=3, ndown=3, U=4.0, nx=3, ny=3)
    trial = uhf_trial(ham, ueff=0.4, ninitial=2, nconv=2000, seed=3)
    psia_before = np.asarray(to_host(trial.psia))
    proj, noons = spin_project_init(ham, trial)
    inita = np.asarray(to_host(proj.inita))
    # Natural orbitals are orthonormal; occupations descending in [0, 2].
    np.testing.assert_allclose(inita.conj().T @ inita, np.eye(3), atol=1e-10)
    assert (noons[:-1] >= noons[1:] - 1e-12).all()
    assert noons[0] <= 2.0 + 1e-9 and noons[-1] >= -1e-9
    np.testing.assert_allclose(np.asarray(to_host(proj.psia)), psia_before)

    fe, noons2 = spin_project_init(ham, trial, init_walker="free_electron")
    assert noons2 is None
    h1 = np.asarray(to_host(ham.T))[0]
    inita = np.asarray(to_host(fe.inita))
    # Columns span the lowest eigvec space: residual of projection is 0.
    e, v = np.linalg.eigh(h1)
    resid = inita - v @ (v.conj().T @ inita)
    np.testing.assert_allclose(resid, 0.0, atol=1e-10)


@pytest.mark.unit
def test_spin_project_init_free_electron_ueg_pwfft():
    """init_walker='free_electron' must work for every model family: UEG
    stores its one-body matrix as H1 (not T) and PW_FFT stores only the
    diagonal sp_eigv (review finding, round 3)."""
    import numpy as np

    from pauxy_jax.models import make_ueg, rhf_identity_trial
    from pauxy_jax.models.pw_fft import make_pw_fft
    from pauxy_jax.models.trial import spin_project_init, trial_from_orbitals
    from pauxy_jax.utils.transfer import to_host

    ham = make_ueg(nup=2, ndown=2, rs=1.0, ecut=1.0)
    trial = rhf_identity_trial(ham)
    fe, noons = spin_project_init(ham, trial, init_walker="free_electron")
    assert noons is None
    inita = np.asarray(to_host(fe.inita))
    h1 = np.asarray(to_host(ham.H1))[0]
    e, v = np.linalg.eigh(h1)
    resid = inita - v @ (v.conj().T @ inita)
    np.testing.assert_allclose(resid, 0.0, atol=1e-10)

    hpw = make_pw_fft(nup=2, ndown=2, rs=1.0, ecut=1.0)
    psi = np.eye(hpw.nbasis)[:, : 4].astype(np.complex128)
    tpw = trial_from_orbitals(hpw, psi)
    fe2, _ = spin_project_init(hpw, tpw, init_walker="free_electron")
    inita2 = np.asarray(to_host(fe2.inita))
    # sp_eigv is diagonal: eigenvectors are coordinate axes, so each column
    # must be a (possibly signed) unit basis vector.
    np.testing.assert_allclose(np.abs(inita2).sum(axis=0), 1.0, atol=1e-10)


@pytest.mark.unit
def test_spin_proj_json_option(tmp_path):
    """The spin_proj trial option is honored through setup_calculation."""
    import numpy as np

    from pauxy_jax.qmc.calc import setup_calculation
    from pauxy_jax.utils.transfer import to_host

    opts = {
        "verbosity": 0,
        "model": {"name": "Hubbard", "nx": 3, "ny": 3, "U": 4,
                  "nup": 3, "ndown": 3},
        "qmc": {"timestep": 0.01, "nsteps": 2, "nblocks": 1,
                "nwalkers": 4, "rng_seed": 1},
        "trial": {"name": "free_electron", "spin_proj": True},
        "estimates": {"filename": str(tmp_path / "sp.h5")},
    }
    af = setup_calculation(opts)
    inita = np.asarray(to_host(af.trial.inita))
    np.testing.assert_allclose(inita.conj().T @ inita, np.eye(3),
                               atol=1e-10)
    rows = af.run()
    assert np.isfinite(rows).all()


@pytest.mark.driver
def test_fully_spin_polarized_systems(tmp_path):
    """ndown=0 (fully spin-polarized): empty determinant blocks must flow
    through overlaps, reortho, the lanes kernels, and every local-energy
    path (review stress find, round 3). With no down spins the Hubbard U
    term is inactive, so the free-electron trial is an exact eigenstate
    and ETotal is exactly the filled-sea energy on both HS paths."""
    import numpy as np

    from pauxy_jax.models import (free_electron_trial, make_hubbard,
                                  make_ueg, rhf_identity_trial)
    from pauxy_jax.qmc import AFQMC, QMCOpts

    ham = make_hubbard(nup=3, ndown=0, U=4.0, nx=3, ny=3)
    e_exact = np.sort(np.linalg.eigvalsh(np.asarray(ham.T)[0]))[:3].sum()
    trial = free_electron_trial(ham)
    qmc = QMCOpts(nwalkers=4, dt=0.01, nsteps=5, nblocks=2, rng_seed=1)
    for hs in ("continuous", "discrete"):
        af = AFQMC(ham, trial, qmc,
                   propagator_options={"hubbard_stratonovich": hs},
                   filename=str(tmp_path / f"pol_{hs}.h5"))
        rows = np.asarray(af.run())
        assert rows[-1, 5].real == pytest.approx(e_exact, abs=1e-8), hs

    ueg = make_ueg(nup=3, ndown=0, rs=1.0, ecut=1.0)
    t = rhf_identity_trial(ueg)
    af = AFQMC(ueg, t, QMCOpts(nwalkers=4, dt=0.005, nsteps=5, nblocks=2,
                               rng_seed=1),
               filename=str(tmp_path / "pol_ueg.h5"))
    rows = np.asarray(af.run())
    assert np.isfinite(rows.real).all()

    # FFT half-rotated energy == dense gather energy on the same state.
    from pauxy_jax.estimators import local_energy as le
    from pauxy_jax.ops import greens
    from pauxy_jax.walkers import init_walkers

    state = init_walkers(t, 3)
    sga = greens.greens_function(state.phia, t.psia)
    ga, gha = sga.G, sga.Ghalf
    m = ueg.nbasis
    etot_half, ke_h, pe_h = le.local_energy_ueg_half(ueg, t, gha,
                                                     gha[:, :0])
    gb = jnp.zeros((3, m, m), ga.dtype)
    etot_dense, ke_d, pe_d = le.local_energy_ueg(ueg, ga, gb)
    np.testing.assert_allclose(np.asarray(etot_half),
                               np.asarray(etot_dense), atol=1e-9)
