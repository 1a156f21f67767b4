"""PW_FFT (FFT-grid UEG) vs the dense-rho UEG implementation.

Both modules describe the identical Hamiltonian, so after mapping the two
basis enumerations onto each other every quantity must agree to machine
precision: local energies, force bias, and the VHS-applied orbitals. The
dense UEG path is itself validated against the reference's Cython kernels
(test_ueg.py), making it the oracle here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pauxy_jax.models.pw_fft import make_pw_fft
from pauxy_jax.models.ueg import make_ueg
from pauxy_jax.models.trial import trial_from_orbitals
from pauxy_jax.propagation import continuous
from pauxy_jax.propagation.planewave import make_planewave
from pauxy_jax.propagation.pw_fft import make_pw_fft_inner
from pauxy_jax.walkers import init_walkers


def build_pair(nup=7, ndown=7, rs=1.0, ecut=1.0):
    ueg = make_ueg(nup=nup, ndown=ndown, rs=rs, ecut=ecut)
    pw = make_pw_fft(nup=nup, ndown=ndown, rs=rs, ecut=ecut)
    assert ueg.nbasis == pw.nbasis
    # basis permutation: ueg index -> pw index
    lut = {tuple(k): i for i, k in enumerate(np.asarray(pw.basis))}
    perm = np.array([lut[tuple(k)] for k in np.asarray(ueg.basis)])
    # q permutation: ueg q (no q=0) -> pw q
    qlut = {tuple(q): i for i, q in enumerate(np.asarray(pw.qvecs))}
    qperm = np.array([qlut[tuple(q)] for q in np.asarray(ueg.qvecs)])
    return ueg, pw, perm, qperm


def occupied_trials(ueg, pw, perm):
    m = ueg.nbasis
    order = np.argsort(np.diagonal(np.asarray(ueg.H1[0])).real, kind="stable")
    occ_a = order[: ueg.nup]
    occ_b = order[: ueg.ndown]
    eye = np.eye(m)
    tr_u = trial_from_orbitals(
        ueg, np.concatenate([eye[:, occ_a], eye[:, occ_b]], axis=1)
    )
    tr_p = trial_from_orbitals(
        pw, np.concatenate([eye[:, perm[occ_a]], eye[:, perm[occ_b]]], axis=1)
    )
    return tr_u, tr_p


@pytest.mark.unit
def test_system_tables_match():
    ueg, pw, perm, qperm = build_pair()
    np.testing.assert_allclose(
        np.asarray(pw.sp_eigv)[perm], np.diagonal(np.asarray(ueg.H1[0])).real, atol=1e-12
    )
    np.testing.assert_allclose(
        np.asarray(pw.vqvec)[qperm], np.asarray(ueg.vqvec), atol=1e-12
    )
    np.testing.assert_allclose(
        np.asarray(pw.h1e_mod)[perm],
        np.diagonal(np.asarray(ueg.h1e_mod[0])), atol=1e-10
    )
    assert pw.ecore == pytest.approx(ueg.ecore, abs=1e-12)
    # q = 0 present in the PW grid but with zero coupling.
    q0 = np.where(np.all(np.asarray(pw.qvecs) == 0, axis=1))[0]
    assert len(q0) == 1 and np.asarray(pw.vqvec)[q0[0]] == 0.0


@pytest.mark.unit
def test_local_energy_matches_dense_ueg():
    from pauxy_jax.estimators.local_energy import (local_energy_pw_fft,
                                                   local_energy_ueg)
    from pauxy_jax.ops.greens import greens_function

    ueg, pw, perm, qperm = build_pair()
    tr_u, tr_p = occupied_trials(ueg, pw, perm)
    key = jax.random.key(4)
    state = init_walkers(tr_u, 3)
    noise = 0.2 * jax.random.normal(
        key, (3, ueg.nbasis, ueg.nup), dtype=jnp.float64
    )
    phia_u = state.phia + noise
    phib_u = state.phib + noise[..., : ueg.ndown]
    ga_u = greens_function(phia_u, tr_u.psia)
    gb_u = greens_function(phib_u, tr_u.psib)
    et_u, ke_u, pe_u = local_energy_ueg(ueg, ga_u.G, gb_u.G)

    # Row permutation: phi_pw[perm[i]] = phi_ueg[i].
    phia_p = jnp.zeros_like(phia_u).at[:, perm].set(phia_u)
    phib_p = jnp.zeros_like(phib_u).at[:, perm].set(phib_u)
    ga_p = greens_function(phia_p, tr_p.psia)
    gb_p = greens_function(phib_p, tr_p.psib)
    et_p, ke_p, pe_p = local_energy_pw_fft(pw, tr_p, ga_p.Ghalf, gb_p.Ghalf)

    np.testing.assert_allclose(np.asarray(ke_p), np.asarray(ke_u), atol=1e-9)
    np.testing.assert_allclose(np.asarray(pe_p), np.asarray(pe_u), atol=1e-9)

    # Host dense version agrees too (used for etrial at build time).
    from pauxy_jax.estimators.local_energy import local_energy_G_host

    g0 = np.stack([np.asarray(ga_p.G[0]), np.asarray(gb_p.G[0])])
    eh, keh, peh = local_energy_G_host(pw, g0)
    assert keh == pytest.approx(complex(ke_p[0]), abs=1e-9)
    assert peh == pytest.approx(complex(pe_p[0]), abs=1e-9)


@pytest.mark.unit
def test_force_bias_and_vhs_match_dense_ueg():
    from pauxy_jax.ops.greens import greens_function

    ueg, pw, perm, qperm = build_pair()
    tr_u, tr_p = occupied_trials(ueg, pw, perm)
    dt = 0.05
    inner_u = make_planewave(ueg, tr_u, dt)
    inner_p = make_pw_fft_inner(pw, tr_p, dt)

    key = jax.random.key(9)
    state = init_walkers(tr_u, 2)
    noise = 0.1 * jax.random.normal(
        key, (2, ueg.nbasis, ueg.nup), dtype=jnp.float64
    )
    phia_u = state.phia + noise
    phib_u = state.phib + noise[..., : ueg.ndown]
    phia_p = jnp.zeros_like(phia_u).at[:, perm].set(phia_u)
    phib_p = jnp.zeros_like(phib_u).at[:, perm].set(phib_u)

    ga_u = greens_function(phia_u, tr_u.psia)
    gb_u = greens_function(phib_u, tr_u.psib)
    ga_p = greens_function(phia_p, tr_p.psia)
    gb_p = greens_function(phib_p, tr_p.psib)

    fb_u = np.asarray(inner_u.force_bias(tr_u, ga_u, gb_u))
    fb_p = np.asarray(inner_p.force_bias(tr_p, ga_p, gb_p))
    nq_u, nq_p = ueg.nq, pw.nq
    np.testing.assert_allclose(fb_p[:, qperm], fb_u[:, :nq_u], atol=1e-9)
    np.testing.assert_allclose(
        fb_p[:, nq_p + qperm], fb_u[:, nq_u:], atol=1e-9
    )
    # q = 0 fields carry no force bias.
    q0 = np.where(np.all(np.asarray(pw.qvecs) == 0, axis=1))[0][0]
    np.testing.assert_allclose(fb_p[:, q0], 0.0, atol=1e-12)

    # Same shifted fields through both VHS implementations.
    x_u = np.asarray(
        jax.random.normal(jax.random.key(3), (2, ueg.nfields),
                          dtype=jnp.float64)
    )
    x_p = np.zeros((2, pw.nfields))
    x_p[:, qperm] = x_u[:, :nq_u]
    x_p[:, nq_p + qperm] = x_u[:, nq_u:]
    va_u, vb_u = inner_u.apply_vhs(phia_u, phib_u, jnp.asarray(x_u))
    va_p, vb_p = inner_p.apply_vhs(phia_p, phib_p, jnp.asarray(x_p))
    np.testing.assert_allclose(
        np.asarray(va_p)[:, perm], np.asarray(va_u), atol=1e-9
    )
    np.testing.assert_allclose(
        np.asarray(vb_p)[:, perm], np.asarray(vb_u), atol=1e-9
    )


@pytest.mark.driver
def test_pw_fft_driver_runs(tmp_path, monkeypatch):
    from pauxy_jax.qmc.calc import setup_calculation

    monkeypatch.chdir(tmp_path)
    drv = setup_calculation({
        "model": {"name": "PW_FFT", "nup": 7, "ndown": 7, "rs": 1.0,
                  "ecut": 1.0},
        "qmc": {"nwalkers": 8, "timestep": 0.01, "num_steps": 4,
                "blocks": 2, "rng_seed": 5, "pop_control_freq": 2,
                "stabilise_freq": 2},
        "trial": {"name": "free_electron"},
        "estimators": {"filename": str(tmp_path / "pw.h5"),
                       "mixed": {"energy_eval_freq": 2}},
        "verbosity": 0,
    })
    rows = drv.run()
    assert np.isfinite(np.asarray(rows)).all()
