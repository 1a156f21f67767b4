"""Analysis / IO / CLI pipeline tests."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from pauxy_jax.analysis import blocking
from pauxy_jax.utils import qmcpack
from pauxy_jax.utils.testing import generate_hamiltonian

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.unit
def test_reblock_recovers_iid_error():
    rng = np.random.default_rng(0)
    x = rng.standard_normal(4096)
    s = blocking.reblock_summary(x)
    assert s["mean"] == pytest.approx(x.mean(), abs=1e-12)
    expected = x.std(ddof=1) / np.sqrt(len(x))
    assert s["standard error"] == pytest.approx(expected, rel=0.3)


@pytest.mark.unit
def test_reblock_detects_correlation():
    """AR(1) series: naive error underestimates; reblocked error should be
    close to the analytic correlated error."""
    rng = np.random.default_rng(1)
    n, rho = 16384, 0.9
    x = np.zeros(n)
    eps = rng.standard_normal(n)
    for i in range(1, n):
        x[i] = rho * x[i - 1] + eps[i]
    s = blocking.reblock_summary(x)
    naive = x.std(ddof=1) / np.sqrt(n)
    # True inflation factor sqrt((1+rho)/(1-rho)) ~ 4.36.
    assert s["standard error"] > 2.5 * naive
    exact = naive * np.sqrt((1 + rho) / (1 - rho))
    assert s["standard error"] == pytest.approx(exact, rel=0.4)


@pytest.mark.unit
def test_qmcpack_roundtrip(tmp_path):
    h1e, chol, enuc, _ = generate_hamiltonian(5, (2, 2), seed=1)
    fn = str(tmp_path / "ham.h5")
    qmcpack.write_hamiltonian(h1e, chol, (2, 2), ecore=enuc, filename=fn)
    h2, c2, e2, nelec = qmcpack.read_hamiltonian(fn)
    np.testing.assert_allclose(h2, h1e, atol=1e-12)
    np.testing.assert_allclose(c2, chol, atol=1e-12)
    assert e2 == pytest.approx(enuc)
    assert nelec == (2, 2)


@pytest.mark.unit
def test_qmcpack_reference_file_compat(tmp_path):
    """A file written by the REFERENCE's writer loads through our reader."""
    if not os.path.isdir("/root/reference/pauxy"):
        pytest.skip("no reference")
    sys.path.insert(0, "/root/reference")
    from pauxy.utils.io import write_qmcpack_sparse

    h1e, chol, enuc, _ = generate_hamiltonian(4, (2, 2), seed=3)
    fn = str(tmp_path / "sparse.h5")
    write_qmcpack_sparse(h1e + 0j, chol.reshape(16, -1), (2, 2), 4,
                         enuc=enuc, filename=fn)
    h2, c2, e2, nelec = qmcpack.read_hamiltonian(fn)
    np.testing.assert_allclose(h2, h1e, atol=1e-12)
    np.testing.assert_allclose(c2, chol, atol=1e-12)
    assert nelec == (2, 2)


@pytest.mark.unit
def test_fcidump_generic_energy(tmp_path):
    """FCIDUMP roundtrip: RHF energy from the loaded system matches the
    direct integral contraction."""
    rng = np.random.default_rng(4)
    m, na = 4, 2
    h1e = rng.standard_normal((m, m))
    h1e = 0.5 * (h1e + h1e.T)
    # Diagonal-dominant PSD ERI via random L.
    l = rng.normal(scale=0.3, size=(m, m, 3))
    l = 0.5 * (l + l.transpose(1, 0, 2))
    eri = np.einsum("ikx,jlx->ikjl", l, l)
    fn = str(tmp_path / "FCIDUMP")
    with open(fn, "w") as f:
        f.write(f"&FCI NORB={m},NELEC={2*na},MS2=0,\n ORBSYM=1,1,1,1,\n ISYM=1,\n&END\n")
        for i in range(m):
            for k in range(i + 1):
                for j in range(m):
                    for ll in range(j + 1):
                        if (i, k) >= (j, ll):
                            v = eri[i, k, j, ll]
                            if abs(v) > 1e-14:
                                f.write(f"{v:.14e} {i+1} {k+1} {j+1} {ll+1}\n")
        for i in range(m):
            for j in range(i + 1):
                if abs(h1e[i, j]) > 1e-14:
                    f.write(f"{h1e[i,j]:.14e} {i+1} {j+1} 0 0\n")
        f.write("0.5 0 0 0 0\n")
    ham = qmcpack.fcidump_to_system(fn)
    assert ham.nbasis == m and ham.nelec == (na, na)
    assert ham.ecore == pytest.approx(0.5)
    # ERI reconstruction through the cholesky factors.
    eri_rec = np.einsum("ikx,jlx->ikjl", np.asarray(ham.chol),
                        np.asarray(ham.chol))
    np.testing.assert_allclose(eri_rec, eri, atol=1e-5)
    np.testing.assert_allclose(np.asarray(ham.H1[0]), h1e, atol=1e-12)


@pytest.mark.driver
def test_cli_end_to_end(tmp_path):
    """bin/pauxy-jax runs an input.json and produces analysable output."""
    inp = {
        "model": {"name": "Hubbard", "nx": 3, "ny": 3, "nup": 3, "ndown": 3,
                  "U": 4.0},
        "qmc": {"timestep": 0.01, "num_steps": 5, "blocks": 6, "nwalkers": 10,
                "rng_seed": 9, "pop_control_freq": 5, "stabilise_freq": 5},
        "trial": {"name": "free_electron"},
        "propagator": {"hubbard_stratonovich": "continuous"},
        "estimates": {"filename": str(tmp_path / "est.h5"),
                      "mixed": {"energy_eval_freq": 1}},
        "verbosity": 0,
    }
    path = tmp_path / "input.json"
    path.write_text(json.dumps(inp))
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "bin", "pauxy-jax"),
         str(path), "--cpu"],
        capture_output=True, text=True, env=env, cwd=str(tmp_path),
        timeout=300,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert "Reblocked estimates" in out.stdout

    # reblock tool on the output
    out2 = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "reblock.py"),
         "-s", "1", "-f", str(tmp_path / "est.h5")],
        capture_output=True, text=True, env=env, timeout=120,
    )
    assert out2.returncode == 0, out2.stderr[-2000:]
    assert "ETotal" in out2.stdout


@pytest.mark.driver
def test_calc_thermal_dispatch(tmp_path):
    from pauxy_jax.qmc.calc import setup_calculation

    driver = setup_calculation({
        "model": {"name": "Hubbard", "nx": 2, "ny": 2, "nup": 2, "ndown": 2,
                  "U": 2.0, "mu": 0.3},
        "qmc": {"timestep": 0.05, "beta": 0.25, "nwalkers": 4, "blocks": 2,
                "rng_seed": 2, "pop_control_freq": 2},
        "estimates": {"filename": str(tmp_path / "t.h5")},
        "verbosity": 0,
    })
    rows = driver.run()
    assert np.isfinite(np.asarray(rows).real).all()


@pytest.mark.driver
def test_checkpoint_resume(tmp_path):
    """Restart reproduces the exact continuation of the original run."""
    from pauxy_jax.models import make_hubbard, free_electron_trial
    from pauxy_jax.qmc import AFQMC, QMCOpts

    ham = make_hubbard(nup=3, ndown=3, U=4.0, nx=3, ny=3)
    trial = free_electron_trial(ham)
    mk = lambda fn, **kw: AFQMC(
        ham, trial,
        QMCOpts(nwalkers=8, dt=0.01, nsteps=5, nblocks=6, nstblz=5,
                npop_control=5, rng_seed=3),
        estimator_options={"mixed": {"energy_eval_freq": 1}},
        filename=str(tmp_path / fn), **kw,
    )
    # Full 6-block run.
    af_full = mk("full.h5")
    rows_full = af_full.run()

    # 3 blocks + checkpoint, then resume for 3 more.
    af_a = mk("a.h5", walker_options={"write_freq": 1,
                                      "write_file": str(tmp_path / "r.h5")})
    for _ in range(3):
        af_a.run_block()
    af_b = mk("b.h5", walker_options={"read_file": str(tmp_path / "r.h5")})
    rows_b = [af_b.run_block() for _ in range(3)]
    got = np.array(rows_b)[:, 5].real
    want = rows_full[3:, 5].real
    np.testing.assert_allclose(got, want, rtol=1e-8)


@pytest.mark.unit
def test_autocorr_reblock():
    from pauxy_jax.analysis.autocorr import integrated_time, reblock_by_autocorr

    rng = np.random.default_rng(2)
    n, rho = 8192, 0.8
    x = np.zeros(n)
    eps = rng.standard_normal(n)
    for i in range(1, n):
        x[i] = rho * x[i - 1] + eps[i]
    tac = integrated_time(x)
    exact = (1 + rho) / (1 - rho)
    assert tac == pytest.approx(exact, rel=0.35)
    df = reblock_by_autocorr(x)
    naive = x.std(ddof=1) / np.sqrt(n)
    assert float(df["ETotal_error_ac"].iloc[0]) > 2.0 * naive


@pytest.mark.unit
def test_rdm_and_correlation_analysis(tmp_path):
    """analyse_one_body / average_rdm / correlation_function on a synthetic
    back-propagated output file (rdm.py:11-31, blocking.py:181-196)."""
    import json

    import h5py

    from pauxy_jax.analysis.correlation import (average_correlation,
                                                correlation_function,
                                                get_strip)
    from pauxy_jax.analysis.rdm import analyse_one_body, average_rdm
    from pauxy_jax.utils.io import H5EstimatorHelper

    m, nblocks, nbp = 4, 6, 5
    fn = str(tmp_path / "est.h5")
    md = {
        "qmc": {"dt": 0.05},
        "system": {"nx": 2, "ny": 2},
        "estimators": {"estimators": {"back_prop": {"splits": [[nbp]]}}},
    }
    rng = np.random.default_rng(3)
    p_true = np.stack([np.diag([0.8, 0.6, 0.4, 0.2]),
                       np.diag([0.2, 0.4, 0.6, 0.8])])
    with h5py.File(fn, "w") as fh5:
        fh5["metadata"] = json.dumps(md)
    helper = H5EstimatorHelper(fn, "back_propagated")
    series = []
    for _ in range(nblocks):
        p = p_true + 0.01 * rng.standard_normal((2, m, m))
        denom = 1.0 + 0.001 * rng.standard_normal()
        series.append(p)
        helper.push(p * denom, f"one_rdm_{nbp}")
        helper.push(np.asarray([denom]), f"denominator_{nbp}")
        helper.increment()

    av, err = average_rdm(fn, skip=1)
    np.testing.assert_allclose(av, np.mean(series[1:], axis=0), atol=1e-3)
    assert err.shape == (2, m, m)

    # <N> with the identity operator = total particle number.
    df = analyse_one_body(fn, np.eye(m), skip=1)
    assert df["OneBody"].iloc[0] == pytest.approx(
        np.trace(p_true[0] + p_true[1]), abs=0.05
    )
    assert df["tau"].iloc[0] == pytest.approx(nbp * 0.05)

    hole, herr, spin, serr, _ = average_correlation(np.asarray(series))
    np.testing.assert_allclose(hole, 1.0 - (p_true[0] + p_true[1]).diagonal(),
                               atol=0.05)
    np.testing.assert_allclose(
        spin, 0.5 * (p_true[0] - p_true[1]).diagonal(), atol=0.05
    )
    df2 = correlation_function(fn, nx=2, ny=2, ix=0, skip=1)
    assert len(df2) == 2  # ny rows on the strip
    # correlation_function divides by the stored denominators and skips the
    # first block; the raw-series strip agrees to the denominator noise.
    c, cerr = get_strip(hole, herr, 0, 2, 2, stag=False)
    np.testing.assert_allclose(df2["hole"], c, atol=0.02)


@pytest.mark.unit
def test_hubbard_fcidump_roundtrip(tmp_path):
    """fcidump() output parses back to the same T and U
    (systems/hubbard.py:106-148)."""
    from pauxy_jax.models import make_hubbard
    from pauxy_jax.models.hubbard import fcidump
    from pauxy_jax.utils.qmcpack import read_fcidump

    ham = make_hubbard(nup=2, ndown=2, U=4.0, nx=4, ny=1)
    fn = str(tmp_path / "FCIDUMP")
    with open(fn, "w") as f:
        f.write(fcidump(ham, to_string=True))
    h1e, eri, ecore, nelec, ms2 = read_fcidump(fn)
    assert nelec == (2, 2) and ms2 == 0 and ecore == 0.0
    np.testing.assert_allclose(h1e, np.asarray(ham.T[0]).real, atol=1e-7)
    for i in range(4):
        assert eri[i, i, i, i] == pytest.approx(4.0)
    eri2 = eri.copy()
    for i in range(4):
        eri2[i, i, i, i] = 0.0
    assert np.abs(eri2).max() == 0.0


@pytest.mark.unit
def test_write_input_and_sys_info(tmp_path):
    import json

    from pauxy_jax.utils.io import get_sys_info, write_input

    fn = str(tmp_path / "input.json")
    write_input(fn, "afqmc.h5", "wfn.h5", bp=True,
                options={"qmc": {"dt": 0.01}})
    full = json.load(open(fn))
    assert full["system"]["integrals"] == "afqmc.h5"
    assert full["qmc"]["dt"] == 0.01          # option merged over default
    assert full["qmc"]["nwalkers"] == 100     # default preserved
    assert full["estimators"]["back_propagated"]["nsplit"] == 4
    info = get_sys_info()
    assert "git_sha" in info and "numpy" in info


@pytest.mark.unit
def test_scaled_temperature_conversion():
    """theta = T/T_F reduced units rescale beta and dt by 1/ef
    (options.py:5-19)."""
    from pauxy_jax.models.ueg import make_ueg
    from pauxy_jax.qmc.options import QMCOpts

    ham = make_ueg(nup=7, ndown=7, rs=1.0, ecut=1.0)
    assert ham.ef > 0
    qmc = QMCOpts.from_dict(
        {"beta": 1.0, "timestep": 0.05, "scaled_temperature": True}
    )
    assert qmc.scaled_temp
    qmc.convert_from_reduced_units(ham)
    assert qmc.beta_scaled == 1.0
    assert qmc.beta == pytest.approx(1.0 / ham.ef)
    assert qmc.dt == pytest.approx(0.05 / ham.ef)


@pytest.mark.driver
def test_timing_breakdown_and_phmsd_input(tmp_path, monkeypatch, capsys):
    """finalise() prints the per-phase table in split mode
    (afqmc.py:260-279) and JSON inputs build PHMSD trials."""
    from pauxy_jax.models import make_hubbard, free_electron_trial
    from pauxy_jax.qmc import AFQMC, QMCOpts
    from pauxy_jax.qmc.calc import get_driver

    monkeypatch.chdir(tmp_path)
    ham = make_hubbard(nup=2, ndown=2, U=4.0, nx=4, ny=1)
    trial = free_electron_trial(ham)
    qmc = QMCOpts(nwalkers=8, dt=0.05, nsteps=4, nblocks=2, nstblz=2,
                  npop_control=2, rng_seed=1)
    af = AFQMC(ham, trial, qmc, block_mode="split",
               estimator_options={"mixed": {"energy_eval_freq": 4}},
               filename=str(tmp_path / "t.h5"))
    af.run()
    af.finalise()
    out = capsys.readouterr().out
    assert "Propagation:" in out and "Population control:" in out
    assert af.timing["prop"] > 0 and af.timing["setup"] > 0

    driver = get_driver({
        "model": {"name": "Hubbard", "nx": 4, "ny": 1, "nup": 2,
                  "ndown": 2, "U": 4.0},
        "qmc": {"nwalkers": 8, "timestep": 0.05, "num_steps": 2,
                "blocks": 1, "rng_seed": 1},
        "trial": {"name": "phmsd", "coefficients": [0.9, 0.3],
                  "occa": [(0, 1), (0, 2)], "occb": [(0, 1), (0, 2)]},
        "estimators": {"filename": str(tmp_path / "p.h5"),
                       "mixed": {"energy_eval_freq": 2}},
    })
    assert driver.trial.ndets == 2
    rows = driver.run()
    assert np.isfinite(np.asarray(rows)[:, 5].real).all()


@pytest.mark.driver
def test_analyse_estimates_and_ekt_ipea(tmp_path, monkeypatch):
    """One-shot analyse_estimates writer + EKT IP/EA eigenproblem
    (``pauxy/analysis/blocking.py:292-362``)."""
    import h5py

    from pauxy_jax.analysis import blocking
    from pauxy_jax.models import make_hubbard, free_electron_trial
    from pauxy_jax.qmc import AFQMC, QMCOpts
    from pauxy_jax.models.generic import make_generic
    from pauxy_jax.models.trial import rhf_identity_trial

    # Generic run with BP + EKT Fock output.
    rng = np.random.default_rng(3)
    nmo, na = 6, 2
    chol = rng.normal(scale=0.05, size=(nmo, nmo, 11))
    chol = 0.5 * (chol + chol.transpose(1, 0, 2))
    h1 = rng.normal(scale=0.2, size=(nmo, nmo))
    h1 = 0.5 * (h1 + h1.T)
    ham = make_generic((na, na), np.stack([h1, h1]), chol, ecore=0.0)
    trial = rhf_identity_trial(ham)
    qmc = QMCOpts(nwalkers=12, dt=0.01, nsteps=10, nblocks=6, nstblz=5,
                  npop_control=5, rng_seed=8)
    fn = str(tmp_path / "ekt.h5")
    af = AFQMC(ham, trial, qmc,
               estimator_options={
                   "mixed": {"energy_eval_freq": 1},
                   "back_propagation": {"tau_bp": 0.1,
                                        "evaluate_energy": True,
                                        "evaluate_ekt": True},
               },
               filename=fn)
    af.run()

    monkeypatch.chdir(tmp_path)
    out = blocking.analyse_estimates(fn, start_time=0.2)
    assert "ETotal" in out.index
    assert np.isfinite(out.loc["ETotal", "mean"])
    assert os.path.exists(str(tmp_path / "analysed_ekt.h5"))
    with h5py.File(str(tmp_path / "analysed_ekt.h5")) as fh5:
        assert "basic/estimates" in fh5
        assert fh5["basic/estimates"].shape[0] == len(out)

    (eip, _), (eea, _) = blocking.analyse_ekt_ipea(fn, ix=10,
                                                   screen_factor=0.0)
    assert np.isfinite(eip).all() and np.isfinite(eea).all()
    assert eip.size > 0 and eea.size > 0


@pytest.mark.driver
def test_extract_raw_and_simple_cli(tmp_path, monkeypatch):
    """tools/extract_raw.py + tools/simple.py counterparts."""
    import subprocess
    import sys as _sys

    from pauxy_jax.models import make_hubbard, free_electron_trial
    from pauxy_jax.qmc import AFQMC, QMCOpts

    ham = make_hubbard(nup=3, ndown=3, U=4.0, nx=3, ny=3)
    trial = free_electron_trial(ham)
    qmc = QMCOpts(nwalkers=10, dt=0.01, nsteps=5, nblocks=4, nstblz=5,
                  npop_control=5, rng_seed=8)
    fn = str(tmp_path / "cli.h5")
    AFQMC(ham, trial, qmc,
          estimator_options={"mixed": {"energy_eval_freq": 1}},
          filename=fn).run()
    root = os.path.join(os.path.dirname(__file__), "..")
    out = subprocess.run(
        [_sys.executable, os.path.join(root, "tools", "extract_raw.py"), fn],
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "ETotal" in out.stdout
    monkeypatch.chdir(tmp_path)
    out = subprocess.run(
        [_sys.executable, os.path.join(root, "tools", "simple.py"),
         "0.1", fn],
        capture_output=True, text=True, timeout=300, cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr
    assert "ETotal" in out.stdout


def test_extract_observable_itcf_selects_live_rows(tmp_path):
    """ITCF rows in the h5 are already normalized; blocks whose
    measurement window didn't complete are zero-filled. The CLI must
    select live rows and NOT divide by the stored (raw-weight)
    denominator again."""
    import subprocess
    import sys as _sys

    from pauxy_jax.models import make_hubbard, free_electron_trial
    from pauxy_jax.qmc import AFQMC, QMCOpts

    ham = make_hubbard(nup=3, ndown=3, U=0.0, nx=3, ny=3)
    trial = free_electron_trial(ham)
    # tau_max = 2 blocks of steps -> every other block is zero-filled.
    qmc = QMCOpts(nwalkers=4, dt=0.05, nsteps=5, nblocks=6, nstblz=100,
                  npop_control=100, rng_seed=3)
    af = AFQMC(ham, trial, qmc,
               estimator_options={"mixed": {"energy_eval_freq": 5},
                                  "itcf": {"tau_max": 0.5, "stable": True}},
               filename=str(tmp_path / "i.h5"))
    af.run()
    out = str(tmp_path / "g.npy")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))
    subprocess.run(
        [_sys.executable,
         os.path.join(env["PYTHONPATH"], "tools", "extract_observable.py"),
         "-f", str(tmp_path / "i.h5"),
         "-o", "itcf:real_space_greens_function", "--out", out],
        check=True, env=env,
    )
    g = np.load(out)
    assert (np.abs(g[:, 0, 0, 0]).max(axis=(-1, -2)) > 0.1).all()
    # U=0 free fermions: G^>(0) diagonal average = 1 - n = 1 - 3/9.
    dens = np.einsum("btsgii->btsgi", g[:, :1, :, :1]).mean()
    assert abs(dens - (1 - 3 / 9)) < 0.05, dens


def test_mom_dist_cli(tmp_path):
    """mom_dist averages BP RDMs and prints n_k + natural occupations."""
    import subprocess
    import sys as _sys

    from pauxy_jax.models import make_hubbard, free_electron_trial
    from pauxy_jax.qmc import AFQMC, QMCOpts

    ham = make_hubbard(nup=3, ndown=3, U=4.0, nx=3, ny=3)
    trial = free_electron_trial(ham)
    qmc = QMCOpts(nwalkers=10, dt=0.01, nsteps=10, nblocks=4, nstblz=5,
                  npop_control=5, rng_seed=8)
    af = AFQMC(ham, trial, qmc,
               estimator_options={
                   "mixed": {"energy_eval_freq": 10},
                   "back_propagation": {"tau_bp": 0.1,
                                        "evaluate_energy": True}},
               filename=str(tmp_path / "md.h5"))
    af.run()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = root
    out = subprocess.run(
        [_sys.executable, os.path.join(root, "tools", "mom_dist.py"),
         "-f", str(tmp_path / "md.h5")],
        check=True, env=env, capture_output=True, text=True,
    ).stdout
    assert "nk" in out
    nk = np.fromstring(out.split("nk = [")[1].split("]")[0], sep=" ")
    # trace of the spin-summed RDM = total electron number.
    assert abs(nk.sum() - 6.0) < 1e-6, nk


def test_finite_temp_analysis_cli(tmp_path):
    """finite_temp_analysis reblocks thermal output per (beta, mu)."""
    import subprocess
    import sys as _sys

    from pauxy_jax.models import make_hubbard
    from pauxy_jax.models.thermal_trial import make_one_body_trial
    from pauxy_jax.qmc import QMCOpts
    from pauxy_jax.qmc.thermal_afqmc import ThermalAFQMC

    ham = make_hubbard(nup=2, ndown=2, U=4.0, nx=2, ny=2)
    trial = make_one_body_trial(ham, beta=0.5, dt=0.05)
    qmc = QMCOpts(nwalkers=8, dt=0.05, nsteps=1, nblocks=4, beta=0.5,
                  npop_control=2, rng_seed=7)
    af = ThermalAFQMC(ham, trial, qmc, filename=str(tmp_path / "ft.h5"))
    af.run()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = root
    out = subprocess.run(
        [_sys.executable,
         os.path.join(root, "tools", "finite_temp_analysis.py"),
         "-f", str(tmp_path / "ft.h5")],
        check=True, env=env, capture_output=True, text=True,
    ).stdout
    assert "ETotal" in out or "E" in out, out


def test_our_extraction_reads_reference_output(tmp_path):
    """Layout compatibility in the reverse direction: a reference-written
    estimates h5 (oracle run) parses through OUR extraction + metadata
    readers (README claims 'and vice versa')."""
    import subprocess
    import sys as _sys

    if not os.path.isdir("/root/reference/pauxy"):
        pytest.skip("reference not available")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = """
from mpi4py import MPI
from pauxy.qmc.afqmc import AFQMC
opts = {
  'verbosity': 0, 'get_sha1': False,
  'model': {'name': 'Hubbard', 'nx': 3, 'ny': 3, 'U': 4, 'nup': 3,
            'ndown': 3, 'ktwist': [0.0, 0.0]},
  'qmc': {'timestep': 0.05, 'num_steps': 10, 'blocks': 4, 'nwalkers': 10,
          'rng_seed': 7},
  'estimates': {'filename': 'ref_est.h5', 'mixed': {'energy_eval_freq': 1}},
}
comm = MPI.COMM_WORLD
af = AFQMC(comm=comm, options=opts, verbose=0)
af.run(comm=comm, verbose=False)
"""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(root, "tools", "oracle"), "/root/reference"])
    subprocess.run([_sys.executable, "-c", code], check=True, env=env,
                   cwd=tmp_path, capture_output=True)

    from pauxy_jax.analysis.extraction import (extract_mixed_estimates,
                                               get_metadata)

    df = extract_mixed_estimates(str(tmp_path / "ref_est.h5"))
    assert len(df) == 4 and "ETotal" in df.columns
    # Format check, not physics: this tiny unequilibrated run with a
    # free-electron trial on a degenerate zero-twist shell fluctuates
    # wildly in the reference itself.
    et = (df.ENumer / df.EDenom).values.real
    assert np.isfinite(et).all()
    assert np.isfinite(df.Weight.values.real).all()
    md = get_metadata(str(tmp_path / "ref_est.h5"))
    assert md["qmc"]["nwalkers"] == 10
