"""s-GTO molecular integrals + the pyscf-free H-chain pipeline.

Validation chain: closed-form anchors (H atom = the zeta=1.24 Slater
expectation, H2 dissociation = 2 E(H)), literature RHF value for H2 at
R=1.4, SCF-energy == framework-trial-energy consistency through the
ortho-AO/Cholesky transforms, AFQMC vs in-repo FCI on H4, and the
reference's published H10 anchor (examples/generic/01-simple/README.rst:
E = -5.38331344 +/- 0.0014386 Ha, Simons benchmark -5.3819 +/- 0.0006).
"""

import numpy as np
import pytest

from pauxy_jax.utils.sgto import (hydrogen_chain, hydrogen_chain_afqmc,
                                  rhf, uhf)


@pytest.mark.unit
def test_h_atom_energy():
    """One contracted function: E = <phi|h|phi>. The zeta=1.24-scaled
    STO-6G fit of a Slater 1s gives the Slater variational value
    zeta^2/2 - zeta = -0.4712 up to the 6-Gaussian fit error."""
    bas, q, c, enuc = hydrogen_chain(1, 1.0)
    e, _, _ = uhf(bas, q, c, (1, 0), enuc=enuc, break_sym=0.0)
    assert e == pytest.approx(-0.471039, abs=2e-5)
    zeta = 1.24
    assert abs(e - (zeta ** 2 / 2 - zeta)) < 5e-4


@pytest.mark.unit
def test_h2_rhf_literature():
    """H2 at R=1.4 a0, STO-6G RHF: -1.12532 Ha (standard minimal-basis
    textbook/literature value; pyscf reproduces it)."""
    bas, q, c, enuc = hydrogen_chain(2, 1.4)
    e, _, _ = rhf(bas, q, c, 1, enuc=enuc)
    assert e == pytest.approx(-1.12532, abs=5e-5)


@pytest.mark.unit
def test_eri_symmetries():
    bas, q, c, _ = hydrogen_chain(3, 1.5)
    eri = bas.eri()
    np.testing.assert_allclose(eri, eri.transpose(1, 0, 2, 3), atol=1e-14)
    np.testing.assert_allclose(eri, eri.transpose(0, 1, 3, 2), atol=1e-14)
    np.testing.assert_allclose(eri, eri.transpose(2, 3, 0, 1), atol=1e-14)
    # (ii|ii) positive, basis normalized.
    assert (np.einsum("iiii->i", eri) > 0).all()
    np.testing.assert_allclose(np.diag(bas.overlap()), 1.0, atol=1e-12)


@pytest.mark.unit
def test_h2_dissociation_limit():
    """UHF at R=8 a0 must reach 2 E(H) (covalent, not ionic)."""
    bas1, q1, c1, e1n = hydrogen_chain(1, 1.0)
    eh, _, _ = uhf(bas1, q1, c1, (1, 0), enuc=e1n, break_sym=0.0)
    bas, q, c, enuc = hydrogen_chain(2, 8.0)
    e, _, _ = uhf(bas, q, c, (1, 1), enuc=enuc, break_sym=0.3)
    assert abs(e - 2 * eh) < 5e-5


@pytest.mark.unit
def test_pipeline_trial_energy_consistency():
    """The numpy SCF energy must equal the framework's variational trial
    energy on the ortho-AO/Cholesky Hamiltonian — one identity spanning
    the integrals, the Lowdin transform, the Cholesky factorization, and
    the Generic local-energy kernel."""
    from pauxy_jax.models.trial import trial_from_orbitals

    ham, psi, e_uhf = hydrogen_chain_afqmc(4, 1.6)
    trial = trial_from_orbitals(ham, psi)
    assert trial.etrial == pytest.approx(e_uhf, abs=1e-9)


@pytest.mark.driver
def test_h4_afqmc_vs_fci(tmp_path):
    """Phaseless AFQMC on the H4 chain lands on the in-repo FCI energy
    (small constrained-path bias allowed)."""
    from pauxy_jax.estimators import ci
    from pauxy_jax.models.trial import trial_from_orbitals
    from pauxy_jax.qmc import AFQMC, QMCOpts

    ham, psi, _ = hydrogen_chain_afqmc(4, 1.6)
    trial = trial_from_orbitals(ham, psi)
    ev, _, _ = ci.simple_fci(ham)
    qmc = QMCOpts(nwalkers=100, dt=0.005, nsteps=10, nblocks=100, nstblz=5,
                  npop_control=5, rng_seed=8)
    af = AFQMC(ham, trial, qmc,
               estimator_options={"mixed": {"energy_eval_freq": 10}},
               filename=str(tmp_path / "h4.h5"))
    rows = af.run()
    et = rows[20:, 5].real
    se = et.std(ddof=1) / len(et) ** 0.5
    assert abs(et.mean() - ev[0]) < max(4 * se, 5e-3), (et.mean(), ev[0])


@pytest.mark.driver
def test_h10_anchor(tmp_path):
    """The reference's headline molecular example without pyscf: H10
    chain, R=1.6 a0, STO-6G, UHF trial, 100 walkers, dt=0.005
    (examples/generic/01-simple). Published anchor -5.38331344 +/-
    0.0014386 Ha; a shorter run here, compared at 4 combined sigma."""
    from pauxy_jax.models.trial import trial_from_orbitals
    from pauxy_jax.qmc import AFQMC, QMCOpts

    ham, psi, e_uhf = hydrogen_chain_afqmc(10, 1.6)
    assert e_uhf == pytest.approx(-5.2562816, abs=1e-5)
    trial = trial_from_orbitals(ham, psi)
    # Full reference length (1000 blocks, ~40 s): the series has a long
    # autocorrelation tail (reblocked sigma still growing at block-40), so
    # short runs under-estimate their own error bar.
    qmc = QMCOpts(nwalkers=100, dt=0.005, nsteps=10, nblocks=1000, nstblz=5,
                  npop_control=5, rng_seed=8)
    af = AFQMC(ham, trial, qmc,
               estimator_options={"mixed": {"energy_eval_freq": 10}},
               filename=str(tmp_path / "h10.h5"))
    rows = af.run()
    # Discard the first 1 a.u. (20 blocks), like the reference's
    # ``reblock.py -s 1.0``; sigma from 40-block reblocking.
    et = rows[20:, 5].real
    b = et[: len(et) // 40 * 40].reshape(-1, 40).mean(axis=1)
    se = b.std(ddof=1) / len(b) ** 0.5
    ref, ref_err = -5.38331344, 0.0014386
    comb = np.hypot(se, ref_err)
    assert abs(et.mean() - ref) < 4 * comb, (et.mean(), se, ref)


@pytest.mark.driver
def test_dump_afqmc_file_workflow(tmp_path):
    """File-based workflow parity: dump_afqmc writes afqmc.h5 + wfn.h5 +
    input.json, and setup_calculation drives them end-to-end (the
    reference's pyscf_to_pauxy.py -> bin/pauxy shape)."""
    import json
    import os

    from pauxy_jax.qmc.calc import setup_calculation
    from pauxy_jax.utils.sgto import dump_afqmc

    f = dump_afqmc(4, 1.6, prefix=str(tmp_path), nblocks=20)
    opts = json.load(open(f))
    opts["estimates"] = {"filename": str(tmp_path / "est.h5")}
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        af = setup_calculation(opts)
        rows = af.run()
    finally:
        os.chdir(cwd)
    et = rows[5:, 5].real
    assert np.isfinite(rows).all()
    # Between the UHF energy (-2.1434) and below, near FCI (-2.1942).
    assert -2.25 < et.mean() < -2.12, et.mean()


@pytest.mark.unit
def test_he_atom_energy():
    """He STO-6G RHF: the zeta=1.69 Slater expectation zeta^2 - 3.375 zeta
    = -2.84765 up to the 6-Gaussian fit error."""
    from pauxy_jax.utils.sgto import molecule

    bas, q, c, enuc = molecule([("He", (0, 0, 0))])
    e, _, _ = rhf(bas, q, c, 1, enuc=enuc)
    assert e == pytest.approx(-2.846292, abs=2e-5)
    assert abs(e - (1.69 ** 2 - 3.375 * 1.69)) < 2e-3


@pytest.mark.driver
def test_hehp_afqmc_vs_fci(tmp_path):
    """HeH+ (2 electrons, 2 orbitals): phaseless AFQMC must land on FCI."""
    from pauxy_jax.estimators import ci
    from pauxy_jax.models.generic import make_generic
    from pauxy_jax.models.trial import trial_from_orbitals
    from pauxy_jax.qmc import AFQMC, QMCOpts
    from pauxy_jax.utils.from_pyscf import cholesky_from_eri
    from pauxy_jax.utils.sgto import molecule, ortho_ao_hamiltonian, rhf

    bas, q, c, enuc = molecule([("He", (0, 0, 0)), ("H", (1.4632, 0, 0))])
    e_rhf, C, _ = rhf(bas, q, c, 1, enuc=enuc)
    h1e, eri, X = ortho_ao_hamiltonian(bas, q, c)
    ham = make_generic((1, 1), h1e, cholesky_from_eri(eri, tol=1e-10),
                       ecore=enuc)
    S = bas.overlap()
    w, U = np.linalg.eigh(S)
    Xinv = U @ np.diag(w ** 0.5) @ U.T
    psi = np.concatenate([Xinv @ C[:, :1]] * 2, axis=1)
    trial = trial_from_orbitals(ham, psi)
    assert trial.etrial == pytest.approx(e_rhf, abs=1e-9)
    ev, _, _ = ci.simple_fci(ham)
    qmc = QMCOpts(nwalkers=50, dt=0.01, nsteps=10, nblocks=60, nstblz=5,
                  npop_control=5, rng_seed=8)
    af = AFQMC(ham, trial, qmc,
               estimator_options={"mixed": {"energy_eval_freq": 10}},
               filename=str(tmp_path / "hehp.h5"))
    rows = af.run()
    et = rows[10:, 5].real
    se = et.std(ddof=1) / len(et) ** 0.5
    assert abs(et.mean() - ev[0]) < max(4 * se, 2e-3), (et.mean(), ev[0])


@pytest.mark.driver
def test_h4_free_projection_converges_to_fci(tmp_path):
    """Free projection on the ab-initio H4 Hamiltonian converges to FCI
    without constraint bias (the molecular analogue of the Hubbard
    free-projection check, tests/test_ci.py)."""
    from pauxy_jax.estimators import ci
    from pauxy_jax.models.trial import trial_from_orbitals
    from pauxy_jax.qmc import AFQMC, QMCOpts

    ham, psi, _ = hydrogen_chain_afqmc(4, 1.6)
    trial = trial_from_orbitals(ham, psi)
    ev, _, _ = ci.simple_fci(ham)
    qmc = QMCOpts(nwalkers=400, dt=0.01, nsteps=25, nblocks=12, nstblz=5,
                  npop_control=1000000, rng_seed=4)
    af = AFQMC(ham, trial, qmc,
               propagator_options={"free_projection": True},
               estimator_options={"mixed": {"energy_eval_freq": 5}},
               filename=str(tmp_path / "fp.h5"))
    rows = af.run()
    e_fp = rows[-1, 5].real
    assert abs(e_fp - ev[0]) < 5e-3, (e_fp, ev[0])
    # Monotone-ish descent from the trial energy toward FCI.
    assert rows[0, 5].real > rows[-1, 5].real


@pytest.mark.driver
def test_h2_mo_basis_vs_reference_golden(tmp_path):
    """Run-for-run molecular parity: our phaseless walk on the MO-basis H2
    Hamiltonian (R=1.4) vs a 300-block golden series from the reference
    run on the IDENTICAL Hamiltonian/trial (oracle, energy every step,
    200 walkers). RNG streams differ by design; compared at 4 combined
    sigma with 10-block reblocking (the per-block series is
    autocorrelated). Golden: tests/data/h2_mo_r1.4.npz."""
    import os

    from pauxy_jax.models.trial import trial_from_orbitals
    from pauxy_jax.qmc import AFQMC, QMCOpts
    from pauxy_jax.utils.sgto import molecule_afqmc

    path = os.path.join(os.path.dirname(__file__), "data",
                        "h2_mo_r1.4.npz")
    if not os.path.exists(path):
        pytest.skip("golden data missing")
    ham, psi, _ = molecule_afqmc([("H", (0, 0, 0)), ("H", (1.4, 0, 0))],
                                 (1, 1), chol_tol=1e-10)
    trial = trial_from_orbitals(ham, psi)
    qmc = QMCOpts(nwalkers=200, dt=0.01, nsteps=10, nblocks=300, nstblz=5,
                  npop_control=5, rng_seed=8)
    af = AFQMC(ham, trial, qmc,
               estimator_options={"mixed": {"energy_eval_freq": 1}},
               filename=str(tmp_path / "h2g.h5"))
    rows = af.run()

    def blocked_se(x):
        b = x[: len(x) // 10 * 10].reshape(-1, 10).mean(axis=1)
        return b.std(ddof=1) / len(b) ** 0.5

    et = rows[150:, 5].real
    ref = np.load(path)["etotal"][150:]
    se = np.hypot(blocked_se(et), blocked_se(ref))
    assert abs(et.mean() - ref.mean()) < 4 * se, (et.mean(), ref.mean(), se)
