"""Driver-tier tests (SURVEY.md section 4, tier 2).

The reference pins trajectory-exact regression numbers against its host RNG
stream; our per-walker counter RNG is a different (deliberate) design, so
driver tests assert *statistical* agreement against golden data generated by
running the reference serially with the SAME trial wavefunction
(tools/oracle/make_golden.py), plus exact structural invariants.
"""

import os

import numpy as np
import pytest

from pauxy_jax.models import make_hubbard, free_electron_trial
from pauxy_jax.models.trial import trial_from_orbitals
from pauxy_jax.qmc import AFQMC, QMCOpts

DATA = os.path.join(os.path.dirname(__file__), "data")
GOLDEN_4X4 = os.path.join(DATA, "hubbard4x4_uhf_continuous.npz")


def load_golden_4x4():
    if not os.path.exists(GOLDEN_4X4):
        pytest.skip("golden data missing; run tools/oracle/make_golden.py")
    return np.load(GOLDEN_4X4)


@pytest.mark.driver
def test_hubbard_4x4_uhf_vs_reference_golden(tmp_path):
    """4x4 Hubbard U=4 (7,7), UHF trial, continuous HS, dt=0.01.

    Golden series generated by the reference implementation with the
    identical trial orbitals; both codes implement the same phaseless
    algorithm, so the equilibrated means must agree statistically.
    (Reference's own pinned 10-block mean for this family:
    -15.14323385684513, test_afqmc.py:186-188.)
    """
    g = load_golden_4x4()
    ham = make_hubbard(nup=7, ndown=7, U=4.0, nx=4, ny=4)
    trial = trial_from_orbitals(ham, np.asarray(g["psi"]))
    # Same trial quality as the oracle run.
    assert trial.etrial == pytest.approx(float(np.real(g["etrial"])), abs=1e-6)

    nblocks = 100
    qmc = QMCOpts(
        nwalkers=int(g["nwalkers"]),
        dt=float(g["dt"]),
        nsteps=int(g["nsteps"]),
        nblocks=nblocks,
        nstblz=10,
        npop_control=1,
        rng_seed=8,
    )
    af = AFQMC(
        ham,
        trial,
        qmc,
        estimator_options={"mixed": {"energy_eval_freq": 1}},
        filename=str(tmp_path / "est.h5"),
    )
    rows = af.run()
    et = rows[:, 5].real
    ref = np.asarray(g["etotal_blocks"])
    skip_mine, skip_ref = len(et) // 3, len(ref) // 3
    mine, theirs = et[skip_mine:], ref[skip_ref:]
    se = np.hypot(
        mine.std(ddof=1) / np.sqrt(len(mine)), theirs.std(ddof=1) / np.sqrt(len(theirs))
    )
    diff = abs(mine.mean() - theirs.mean())
    assert diff < max(4 * se, 0.05), (mine.mean(), theirs.mean(), se)


@pytest.mark.driver
def test_weights_bounded_and_finite(tmp_path):
    g = load_golden_4x4()
    ham = make_hubbard(nup=7, ndown=7, U=4.0, nx=4, ny=4)
    trial = trial_from_orbitals(ham, np.asarray(g["psi"]))
    qmc = QMCOpts(
        nwalkers=24, dt=0.01, nsteps=10, nblocks=20, nstblz=10,
        npop_control=1, rng_seed=1,
    )
    af = AFQMC(
        ham, trial, qmc,
        estimator_options={"mixed": {"energy_eval_freq": 1}},
        filename=str(tmp_path / "est.h5"),
    )
    rows = af.run()
    assert np.isfinite(rows.real).all()
    weights = rows[:, 2].real
    # Pop control every step keeps the population pinned near the target.
    assert np.all(weights > 12) and np.all(weights < 48), weights


@pytest.mark.driver
def test_h5_output_readable_by_reference_tooling(tmp_path):
    import sys

    if not os.path.isdir("/root/reference/pauxy"):
        pytest.skip("reference not available")
    ham = make_hubbard(nup=3, ndown=3, U=4.0, nx=3, ny=3)
    trial = free_electron_trial(ham)
    qmc = QMCOpts(nwalkers=10, dt=0.01, nsteps=5, nblocks=3, rng_seed=2)
    af = AFQMC(ham, trial, qmc, filename=str(tmp_path / "est.h5"))
    af.run()
    sys.path.insert(0, "/root/reference")
    from pauxy.analysis.extraction import extract_mixed_estimates

    df = extract_mixed_estimates(str(tmp_path / "est.h5"))
    assert len(df) == 3
    assert "ETotal" in df.columns


@pytest.mark.driver
def test_split_block_mode_matches_fused(tmp_path):
    """block_mode='split' must reproduce the fused scan block exactly."""
    ham = make_hubbard(nup=3, ndown=3, U=4.0, nx=3, ny=3)
    trial = free_electron_trial(ham)
    qmc = QMCOpts(nwalkers=8, dt=0.01, nsteps=6, nblocks=3, nstblz=2,
                  npop_control=3, rng_seed=5)
    rows = {}
    for mode in ("fused", "split"):
        af = AFQMC(ham, trial, qmc,
                   estimator_options={"mixed": {"energy_eval_freq": 1}},
                   filename=str(tmp_path / f"{mode}.h5"), block_mode=mode)
        rows[mode] = af.run()
    np.testing.assert_allclose(
        rows["fused"][:, 1:10].real, rows["split"][:, 1:10].real,
        rtol=1e-8, atol=1e-10,
    )


@pytest.mark.driver
def test_split_block_mode_matches_fused_bp_itcf(tmp_path):
    """Split mode must reproduce the fused block exactly WITH BP (nsplit=2)
    and ITCF enabled — VERDICT r1 item 7 (previously asserted unsupported)."""
    import os, sys

    ham = make_hubbard(nup=3, ndown=3, U=4.0, nx=3, ny=3)
    trial = free_electron_trial(ham)
    qmc = QMCOpts(nwalkers=8, dt=0.01, nsteps=8, nblocks=3, nstblz=4,
                  npop_control=4, rng_seed=5)
    eopts = {
        "mixed": {"energy_eval_freq": 1},
        "back_propagation": {"tau_bp": 0.08, "evaluate_energy": True,
                             "nsplit": 2, "two_rdm": "full"},
        "itcf": {"tau_max": 0.04, "tau_eqlb": 0.04},
    }
    rows = {}
    for mode in ("fused", "split"):
        af = AFQMC(ham, trial, qmc, estimator_options=eopts,
                   filename=str(tmp_path / f"{mode}_bpitcf.h5"),
                   block_mode=mode)
        rows[mode] = af.run()
    np.testing.assert_allclose(
        rows["fused"][:, 1:10].real, rows["split"][:, 1:10].real,
        rtol=1e-7, atol=1e-9,
    )
    if not os.path.isdir("/root/reference/pauxy"):
        return
    sys.path.insert(0, "/root/reference")
    from pauxy.analysis.extraction import extract_data

    # two_rdm included: the split path's zero-filled BP accumulator must
    # size the two_rdm tail exactly like the fused path (ADVICE r2 medium).
    for name in ("energies_4", "energies_8", "one_rdm_4", "one_rdm_8",
                 "two_rdm_4", "two_rdm_8"):
        a = extract_data(str(tmp_path / "fused_bpitcf.h5"),
                         "back_propagated", name, raw=True)
        b = extract_data(str(tmp_path / "split_bpitcf.h5"),
                         "back_propagated", name, raw=True)
        np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-9)
    a = extract_data(str(tmp_path / "fused_bpitcf.h5"), "itcf",
                     "real_space_greens_function", raw=True)
    b = extract_data(str(tmp_path / "split_bpitcf.h5"), "itcf",
                     "real_space_greens_function", raw=True)
    np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-9)


@pytest.mark.driver
def test_ueg_vs_reference_golden(tmp_path):
    """UEG rs=2.44, ecut=2, (7,7), HF trial, dt=0.01 — the reference's UEG
    regression family (pauxy/qmc/tests/test_afqmc.py:49-97), compared
    statistically against a 100-block oracle series."""
    path = os.path.join(DATA, "ueg_rs2.44_ecut2.npz")
    if not os.path.exists(path):
        pytest.skip("golden data missing; run tools/oracle/make_golden.py")
    g = np.load(path)
    from pauxy_jax.models import make_ueg, rhf_identity_trial

    ham = make_ueg(nup=int(g["nup"]), ndown=int(g["ndown"]),
                   rs=float(g["rs"]), ecut=float(g["ecut"]))
    trial = rhf_identity_trial(ham)
    assert trial.etrial == pytest.approx(float(g["etrial"]), abs=1e-6)

    qmc = QMCOpts(nwalkers=int(g["nwalkers"]), dt=float(g["dt"]),
                  nsteps=int(g["nsteps"]), nblocks=100, nstblz=10,
                  npop_control=1, rng_seed=8)
    af = AFQMC(ham, trial, qmc,
               estimator_options={"mixed": {"energy_eval_freq": 1}},
               filename=str(tmp_path / "ueg.h5"))
    rows = af.run()
    et = rows[:, 5].real
    ref = np.asarray(g["etotal_blocks"])
    mine, theirs = et[len(et) // 3:], ref[len(ref) // 3:]
    se = np.hypot(mine.std(ddof=1) / np.sqrt(len(mine)),
                  theirs.std(ddof=1) / np.sqrt(len(theirs)))
    diff = abs(mine.mean() - theirs.mean())
    assert diff < max(4 * se, 0.05), (mine.mean(), theirs.mean(), se)


@pytest.mark.driver
def test_generic_vs_reference_golden(tmp_path):
    """Random Generic nmo=11 (3,3) (seed-7 Hamiltonian), dt=0.005 — the
    reference's Generic regression family (test_afqmc.py:191-232), with the
    IDENTICAL Hamiltonian and trial orbitals from the golden file."""
    path = os.path.join(DATA, "generic_nmo11.npz")
    if not os.path.exists(path):
        pytest.skip("golden data missing; run tools/oracle/make_golden.py")
    g = np.load(path)
    from pauxy_jax.models.generic import make_generic

    h1e = np.asarray(g["h1e"])
    nmo = h1e.shape[-1]
    # Reference packs chol as [nchol, M, M] -> [M^2, nchol] column-major of
    # (ik); ours is [M, M, X].
    chol = np.asarray(g["chol"]).reshape(-1, nmo, nmo).transpose(1, 2, 0)
    ham = make_generic((3, 3), np.stack([h1e, h1e]), chol,
                       ecore=float(g["enuc"]))
    trial = trial_from_orbitals(ham, np.asarray(g["psi"]))

    qmc = QMCOpts(nwalkers=int(g["nwalkers"]), dt=float(g["dt"]),
                  nsteps=int(g["nsteps"]), nblocks=100, nstblz=10,
                  npop_control=1, rng_seed=8)
    af = AFQMC(ham, trial, qmc,
               estimator_options={"mixed": {"energy_eval_freq": 1}},
               filename=str(tmp_path / "gen.h5"))
    rows = af.run()
    et = rows[:, 5].real
    ref = np.asarray(g["etotal_blocks"])
    mine, theirs = et[len(et) // 3:], ref[len(ref) // 3:]
    se = np.hypot(mine.std(ddof=1) / np.sqrt(len(mine)),
                  theirs.std(ddof=1) / np.sqrt(len(theirs)))
    diff = abs(mine.mean() - theirs.mean())
    assert diff < max(4 * se, 0.02), (mine.mean(), theirs.mean(), se)


@pytest.mark.driver
def test_profiler_trace_capture(tmp_path):
    """profile_dir captures a JAX profiler trace of the run (SURVEY 5:
    tracing subsystem; counterpart of the reference's timer table)."""
    import glob

    ham = make_hubbard(nup=3, ndown=3, U=4.0, nx=3, ny=3)
    trial = free_electron_trial(ham)
    qmc = QMCOpts(nwalkers=8, dt=0.01, nsteps=3, nblocks=2, nstblz=3,
                  npop_control=3, rng_seed=1)
    af = AFQMC(ham, trial, qmc,
               estimator_options={"mixed": {"energy_eval_freq": 3}},
               filename=str(tmp_path / "p.h5"),
               profile_dir=str(tmp_path / "trace"))
    rows = af.run()
    assert np.isfinite(rows.real).all()
    assert glob.glob(str(tmp_path / "trace" / "plugins" / "profile" / "*"))


@pytest.mark.driver
def test_get_energy_get_one_rdm_hooks(tmp_path):
    """Driver post-analysis hooks (``pauxy/qmc/afqmc.py:297-339``)."""
    ham = make_hubbard(nup=3, ndown=3, U=4.0, nx=3, ny=3)
    trial = free_electron_trial(ham)
    qmc = QMCOpts(nwalkers=12, dt=0.01, nsteps=10, nblocks=5, nstblz=5,
                  npop_control=5, rng_seed=8)
    af = AFQMC(ham, trial, qmc,
               estimator_options={
                   "mixed": {"energy_eval_freq": 1, "one_rdm": True},
                   "back_propagation": {"tau_bp": 0.1,
                                        "evaluate_energy": True},
               },
               filename=str(tmp_path / "hooks.h5"))
    rows = af.run()
    e, err = af.get_energy(skip=1)
    assert np.isfinite(e) and err >= 0
    assert abs(e - rows[1:, 5].real.mean()) < 0.5
    av, rdm_err = af.get_one_rdm()
    assert av.shape == (2, 9, 9)
    assert np.einsum("sii->", av).real == pytest.approx(6.0, abs=1e-5)


@pytest.mark.unit
def test_estimates_filename_overwrite_false(tmp_path, monkeypatch):
    """estimates basename/index/overwrite naming follows the reference
    (estimators/handler.py:60-69): overwrite=false auto-increments the
    index past existing files (the scan workflows keep one file per
    parameter point this way)."""
    from pauxy_jax.utils.io import resolve_estimates_filename

    monkeypatch.chdir(tmp_path)
    assert resolve_estimates_filename({}) == "estimates.0.h5"
    assert resolve_estimates_filename({"filename": "x.h5"}) == "x.h5"
    assert resolve_estimates_filename(
        {"basename": "scan", "index": 3}) == "scan.3.h5"
    open("scan.0.h5", "w").close()
    open("scan.1.h5", "w").close()
    assert resolve_estimates_filename(
        {"basename": "scan", "overwrite": False}) == "scan.2.h5"
    # overwrite true (default) keeps the requested index.
    assert resolve_estimates_filename({"basename": "scan"}) == "scan.0.h5"

    ham = make_hubbard(nup=3, ndown=3, U=4.0, nx=3, ny=3)
    trial = free_electron_trial(ham)
    qmc = QMCOpts(nwalkers=4, dt=0.01, nsteps=2, nblocks=1, rng_seed=1)
    af = AFQMC(ham, trial, qmc,
               estimator_options={"mixed": {},
                                  "basename": "run", "overwrite": False})
    assert af.filename == "run.0.h5"
    af2 = AFQMC(ham, trial, qmc,
                estimator_options={"mixed": {},
                                   "basename": "run", "overwrite": False})
    assert af2.filename == "run.1.h5"
