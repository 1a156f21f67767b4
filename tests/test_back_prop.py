"""Back-propagation estimator tests."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg

from pauxy_jax.estimators import back_prop
from pauxy_jax.models import make_hubbard, free_electron_trial
from pauxy_jax.propagation import continuous as cont
from pauxy_jax.propagation.hubbard import make_hubbard_continuous
from pauxy_jax.qmc import AFQMC, QMCOpts
from pauxy_jax.walkers import init_walkers


@pytest.mark.unit
def test_back_propagate_continuous_vs_numpy():
    """Reverse field application matches a dense numpy loop building
    B = BH1 e^{VHS} BH1 and applying B^dagger in reverse order."""
    ham = make_hubbard(nup=3, ndown=3, U=4.0, nx=3, ny=3)
    trial = free_electron_trial(ham)
    inner = make_hubbard_continuous(ham, trial, 0.01)
    prop = cont.Continuous(inner=inner, dt=0.01)
    nw, nbp, nf = 2, 4, ham.nfields
    rng = np.random.default_rng(4)
    configs = rng.standard_normal((nw, nbp, nf)) + 0.1j * rng.standard_normal(
        (nw, nbp, nf)
    )
    pa, pb = back_prop.back_propagate_continuous(
        prop, trial, jnp.asarray(configs), nstblz=100
    )
    bh1 = np.asarray(inner.BH1)
    iu = 1j * 2.0  # i sqrt(U)
    for w in range(nw):
        phi_a = np.asarray(trial.psia).copy()
        phi_b = np.asarray(trial.psib).copy()
        for x in configs[w][::-1]:
            vhs = np.sqrt(0.01) * iu * np.diag(x)
            ba = bh1[0] @ scipy.linalg.expm(vhs) @ bh1[0]
            bb = bh1[1] @ scipy.linalg.expm(vhs) @ bh1[1]
            phi_a = ba.conj().T @ phi_a
            phi_b = bb.conj().T @ phi_b
        np.testing.assert_allclose(np.asarray(pa[w]), phi_a, atol=1e-10)
        np.testing.assert_allclose(np.asarray(pb[w]), phi_b, atol=1e-10)


@pytest.mark.unit
def test_bp_greens_trace():
    """BP Green's function is a projector cross term: tr G_s = n_s."""
    ham = make_hubbard(nup=3, ndown=3, U=4.0, nx=3, ny=3)
    trial = free_electron_trial(ham)
    rng = np.random.default_rng(1)
    shape = (3, ham.nbasis, 3)
    pa = jnp.asarray(rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
    pb = jnp.asarray(rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
    qa = jnp.asarray(rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
    qb = jnp.asarray(rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
    ga, gb = back_prop.bp_greens_function(pa, pb, qa, qb)
    tr = np.trace(np.asarray(ga), axis1=-2, axis2=-1)
    np.testing.assert_allclose(tr, 3.0, atol=1e-9)


@pytest.mark.driver
def test_bp_driver_hubbard(tmp_path):
    """End-to-end BP on 3x3 Hubbard continuous: RDM normalization + energies
    finite; h5 readable through the reference's extract_rdm."""
    ham = make_hubbard(nup=3, ndown=3, U=4.0, nx=3, ny=3)
    trial = free_electron_trial(ham)
    qmc = QMCOpts(nwalkers=20, dt=0.01, nsteps=10, nblocks=6, nstblz=5,
                  npop_control=5, rng_seed=8)
    af = AFQMC(
        ham, trial, qmc,
        estimator_options={
            "mixed": {"energy_eval_freq": 1},
            "back_propagation": {"tau_bp": 0.1, "evaluate_energy": True},
        },
        filename=str(tmp_path / "bp.h5"),
    )
    assert af.nbp == 10
    af.run()

    if not os.path.isdir("/root/reference/pauxy"):
        return
    sys.path.insert(0, "/root/reference")
    from pauxy.analysis.extraction import extract_rdm, extract_data

    rdm = extract_rdm(str(tmp_path / "bp.h5"), ix=10)
    assert rdm.shape[1:] == (2, 9, 9)
    # <tr G_s> = n_s for every block measurement.
    traces = np.einsum("bsii->bs", rdm)
    np.testing.assert_allclose(traces.real, 3.0, atol=1e-6)
    en = extract_data(str(tmp_path / "bp.h5"), "back_propagated", "energies_10",
                      raw=True)
    assert np.isfinite(en).all()
    # BP energy should be in the same ballpark as the mixed energy.
    assert -12.0 < en[-1][0].real < -5.0


@pytest.mark.driver
def test_bp_driver_discrete(tmp_path):
    ham = make_hubbard(nup=3, ndown=3, U=4.0, nx=3, ny=3)
    trial = free_electron_trial(ham)
    qmc = QMCOpts(nwalkers=16, dt=0.01, nsteps=10, nblocks=4, nstblz=5,
                  npop_control=5, rng_seed=8)
    af = AFQMC(
        ham, trial, qmc,
        propagator_options={"hubbard_stratonovich": "discrete"},
        estimator_options={
            "mixed": {"energy_eval_freq": 1},
            "back_propagation": {"tau_bp": 0.1, "evaluate_energy": True},
        },
        filename=str(tmp_path / "bpd.h5"),
    )
    rows = af.run()
    assert np.isfinite(rows.real).all()


@pytest.mark.driver
def test_bp_nsplit_schedule(tmp_path):
    """nsplit=2 must produce BP datasets at BOTH split times, and the final
    split must be IDENTICAL to an nsplit=1 run (same RNG stream — the extra
    mid-buffer measurement does not mutate walker state).
    Reference: ``pauxy/estimators/back_propagation.py:70-72,144-147``."""
    ham = make_hubbard(nup=3, ndown=3, U=4.0, nx=3, ny=3)
    trial = free_electron_trial(ham)
    qmc = QMCOpts(nwalkers=16, dt=0.01, nsteps=10, nblocks=4, nstblz=5,
                  npop_control=5, rng_seed=8)

    outs = {}
    for nsplit in (1, 2):
        fn = str(tmp_path / f"bp{nsplit}.h5")
        af = AFQMC(
            ham, trial, qmc,
            estimator_options={
                "mixed": {"energy_eval_freq": 1},
                "back_propagation": {"tau_bp": 0.1, "evaluate_energy": True,
                                     "nsplit": nsplit},
            },
            filename=fn,
        )
        af.run()
        outs[nsplit] = fn

    if not os.path.isdir("/root/reference/pauxy"):
        return
    sys.path.insert(0, "/root/reference")
    from pauxy.analysis.extraction import extract_data, extract_rdm

    e10_a = extract_data(outs[1], "back_propagated", "energies_10", raw=True)
    e10_b = extract_data(outs[2], "back_propagated", "energies_10", raw=True)
    np.testing.assert_allclose(e10_b, e10_a, rtol=1e-6)
    e5 = extract_data(outs[2], "back_propagated", "energies_5", raw=True)
    assert np.isfinite(e5).all()
    assert e5.shape == e10_b.shape
    # Shorter BP time -> closer to the mixed estimate, still bounded.
    assert -12.0 < e5[-1][0].real < -5.0
    rdm5 = extract_rdm(outs[2], ix=5)
    np.testing.assert_allclose(np.einsum("bsii->bs", rdm5).real, 3.0,
                               atol=1e-6)


@pytest.mark.driver
def test_bp_two_rdm_full_and_structure_factor(tmp_path):
    """BP 2-RDM outputs (``back_propagation.py:87-94,168-175,207-210``):
    the spin-summed full 2-RDM must contract against the Hubbard ERI to the
    BP two-body energy, and the UEG structure factor to its E2Body."""
    ham = make_hubbard(nup=3, ndown=3, U=4.0, nx=3, ny=3)
    trial = free_electron_trial(ham)
    qmc = QMCOpts(nwalkers=12, dt=0.01, nsteps=10, nblocks=3, nstblz=5,
                  npop_control=5, rng_seed=8)
    fn = str(tmp_path / "bp2.h5")
    af = AFQMC(
        ham, trial, qmc,
        estimator_options={
            "mixed": {"energy_eval_freq": 1},
            "back_propagation": {"tau_bp": 0.1, "evaluate_energy": True,
                                 "two_rdm": "full"},
        },
        filename=fn,
    )
    af.run()
    if not os.path.isdir("/root/reference/pauxy"):
        return
    sys.path.insert(0, "/root/reference")
    from pauxy.analysis.extraction import extract_data

    den = extract_data(fn, "back_propagated", "denominator_10", raw=True)
    two = extract_data(fn, "back_propagated", "two_rdm_10", raw=True)
    en = extract_data(fn, "back_propagated", "energies_10", raw=True)
    m = ham.nbasis
    assert two.shape[1:] == (m, m, m, m)
    u = float(ham.U)
    for b in range(two.shape[0]):
        rdm = two[b] / den[b][0]
        # Hubbard: E2 = U/2 sum_i <n_i (n_i - ...)> = 1/2 sum eri*rdm with
        # eri[p,r,q,s] = U delta_{prqs}.
        e2 = 0.5 * u * np.einsum("pppp->", rdm)
        assert abs(e2 - en[b][2]) < 1e-6, (b, e2, en[b][2])

    # UEG structure factor flavor.
    from pauxy_jax.models import make_ueg, rhf_identity_trial

    ueg = make_ueg(nup=2, ndown=2, rs=1.0, ecut=0.5)
    tueg = rhf_identity_trial(ueg)
    fn2 = str(tmp_path / "bp2u.h5")
    af = AFQMC(
        ueg, tueg, qmc,
        estimator_options={
            "mixed": {"energy_eval_freq": 1},
            "back_propagation": {"tau_bp": 0.1, "evaluate_energy": True,
                                 "two_rdm": "structure_factor"},
        },
        filename=fn2,
    )
    af.run()
    den = extract_data(fn2, "back_propagated", "denominator_10", raw=True)
    sk = extract_data(fn2, "back_propagated", "two_rdm_10", raw=True)
    en = extract_data(fn2, "back_propagated", "energies_10", raw=True)
    assert sk.shape[1:] == (2, 2, ueg.nq)
    vq = np.asarray(ueg.vqvec)
    fac = 1.0 / (2.0 * ueg.vol)
    for b in range(sk.shape[0]):
        pe = fac * np.sum(vq * (sk[b] / den[b][0]).sum(axis=(0, 1)))
        assert abs(pe - en[b][2]) < 1e-6, (b, pe, en[b][2])
