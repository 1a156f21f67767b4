"""ITCF estimator tests.

The sharpest oracle is the non-interacting limit: at U=0 the continuous-HS
propagator is exactly B = exp(-dt T), so with the free-electron trial
G_greater(tau) = exp(-tau T)(I - P_occ) and G_lesser(tau) = P_occ exp(tau T)
analytically.
"""

import numpy as np
import pytest
import scipy.linalg

from pauxy_jax.models import make_hubbard, free_electron_trial
from pauxy_jax.qmc import AFQMC, QMCOpts


def analytic_free_itcf(ham, trial, dt, ntau):
    t = np.asarray(ham.T[0])
    psi = np.asarray(trial.psia)
    p = psi @ np.linalg.inv(psi.conj().T @ psi) @ psi.conj().T
    m = t.shape[0]
    out = np.zeros((ntau + 1, 2, m, m), dtype=complex)
    for n in range(ntau + 1):
        bgr = scipy.linalg.expm(-n * dt * t)
        bls = scipy.linalg.expm(n * dt * t)
        out[n, 0] = bgr @ (np.eye(m) - p)
        out[n, 1] = p @ bls
    return out


@pytest.mark.driver
@pytest.mark.parametrize("stable", [False, True])
def test_itcf_free_fermions(tmp_path, stable):
    ham = make_hubbard(nup=3, ndown=3, U=0.0, nx=3, ny=3)
    trial = free_electron_trial(ham)
    ntau = 5
    dt = 0.05
    qmc = QMCOpts(nwalkers=4, dt=dt, nsteps=ntau, nblocks=2, nstblz=100,
                  npop_control=100, rng_seed=3)
    af = AFQMC(
        ham, trial, qmc,
        estimator_options={
            "mixed": {"energy_eval_freq": 1},
            "itcf": {"tau_max": ntau * dt, "stable": stable},
        },
        filename=str(tmp_path / f"itcf{stable}.h5"),
    )
    assert af.nitcf == ntau
    af.run()

    import h5py

    with h5py.File(str(tmp_path / f"itcf{stable}.h5"), "r") as fh5:
        keys = sorted(fh5["itcf/real_space_greens_function"].keys())
        spgf = fh5[f"itcf/real_space_greens_function/{keys[-1]}"][:]
    ref = analytic_free_itcf(ham, trial, dt, ntau)
    for n in range(ntau + 1):
        np.testing.assert_allclose(
            spgf[n, 0, 0], ref[n, 0].real, atol=1e-8,
            err_msg=f"Ggr tau index {n}",
        )
        np.testing.assert_allclose(
            spgf[n, 0, 1], ref[n, 1].real, atol=1e-8,
            err_msg=f"Gls tau index {n}",
        )


@pytest.mark.driver
def test_itcf_interacting_sanity(tmp_path):
    """U=4: tau=0 diagonal of Ggr + Gls must be the identity decomposition
    (Ggr + Gls = I at equal time) and G decays with tau."""
    ham = make_hubbard(nup=3, ndown=3, U=4.0, nx=3, ny=3)
    trial = free_electron_trial(ham)
    qmc = QMCOpts(nwalkers=12, dt=0.05, nsteps=10, nblocks=3, nstblz=5,
                  npop_control=5, rng_seed=7)
    af = AFQMC(
        ham, trial, qmc,
        estimator_options={
            "mixed": {"energy_eval_freq": 1},
            "itcf": {"tau_max": 0.5, "stable": True},
        },
        filename=str(tmp_path / "itcf_u4.h5"),
    )
    af.run()
    import h5py

    with h5py.File(str(tmp_path / "itcf_u4.h5"), "r") as fh5:
        keys = sorted(fh5["itcf/real_space_greens_function"].keys())
        spgf = fh5[f"itcf/real_space_greens_function/{keys[-1]}"][:]
    assert np.isfinite(spgf).all()
    eye_sum = spgf[0, 0, 0] + spgf[0, 0, 1]
    np.testing.assert_allclose(eye_sum, np.eye(ham.nbasis), atol=1e-6)
    # On-site greater function decays in imaginary time.
    assert spgf[-1, 0, 0, 0, 0] < spgf[0, 0, 0, 0, 0]


@pytest.mark.driver
def test_itcf_kspace_free_fermions(tmp_path):
    """kspace=True writes G_k(tau); for U=0 with the free-electron trial the
    tau=0 lesser diagonal is the exact momentum occupation n_k and
    G_k^gr(tau) on an empty/full band decays as e^{-tau e_k}."""
    ham = make_hubbard(nup=3, ndown=3, U=0.0, nx=3, ny=3)
    trial = free_electron_trial(ham)
    ntau, dt = 4, 0.05
    qmc = QMCOpts(nwalkers=4, dt=dt, nsteps=ntau, nblocks=2, nstblz=100,
                  npop_control=100, rng_seed=3)
    af = AFQMC(
        ham, trial, qmc,
        estimator_options={
            "mixed": {"energy_eval_freq": 1},
            "itcf": {"tau_max": ntau * dt, "kspace": True},
        },
        filename=str(tmp_path / "itcfk.h5"),
    )
    af.run()

    import h5py

    with h5py.File(str(tmp_path / "itcfk.h5"), "r") as fh5:
        keys = sorted(fh5["itcf/k_space_greens_function"].keys())
        gk = fh5[f"itcf/k_space_greens_function/{keys[-1]}"][:]
    assert gk.shape == (ntau + 1, 2, 2, 9)
    # At tau=0: n_k sums to nup; occupations are 0/1 for the exact
    # plane-wave trial (k-ordering is ky*nx + kx by construction).
    nk = gk[0, 0, 1]
    assert nk.sum() == pytest.approx(3.0, abs=1e-8)
    # e(k) for the 3x3 lattice in the FFT's ky*nx+kx ordering.
    ks = 2 * np.pi * np.arange(3) / 3
    ek = -2.0 * (np.cos(ks)[None, :] + np.cos(ks)[:, None]).reshape(-1)
    # Greater function decays with e_k: G^gr_k(tau) = e^{-tau e_k} (1 - n_k).
    for n in range(ntau + 1):
        expect = np.exp(-n * dt * ek) * (1.0 - nk)
        np.testing.assert_allclose(gk[n, 0, 0], expect, atol=1e-7)


@pytest.mark.driver
def test_itcf_output_modes(tmp_path):
    """'diagonal' and element-list output modes slice the stored ITCF the
    way the reference does (``pauxy/estimators/itcf.py:570-575``)."""
    import os, sys
    if not os.path.isdir("/root/reference/pauxy"):
        pytest.skip("no reference")
    sys.path.insert(0, "/root/reference")
    from pauxy.analysis.extraction import extract_data

    ham = make_hubbard(nup=3, ndown=3, U=4.0, nx=3, ny=3)
    trial = free_electron_trial(ham)
    qmc = QMCOpts(nwalkers=10, dt=0.01, nsteps=10, nblocks=2, nstblz=5,
                  npop_control=5, rng_seed=8)
    full = {}
    for mode in ("full", "diagonal", [[0, 0], [0, 1]]):
        fn = str(tmp_path / f"itcf_{'el' if isinstance(mode, list) else mode}.h5")
        af = AFQMC(
            ham, trial, qmc,
            estimator_options={
                "mixed": {"energy_eval_freq": 1},
                "itcf": {"tau_max": 0.1, "mode": mode},
            },
            filename=fn,
        )
        af.run()
        full[str(mode)] = extract_data(fn, "itcf",
                                       "real_space_greens_function", raw=True)
    g_full = full["full"]
    assert g_full.shape[1:] == (11, 2, 2, 9, 9)
    g_diag = full["diagonal"]
    assert g_diag.shape[1:] == (11, 2, 2, 9)
    np.testing.assert_allclose(g_diag, np.einsum("btsoii->btsoi", g_full),
                               atol=1e-12)
    g_el = full[str([[0, 0], [0, 1]])]
    assert g_el.shape[1:] == (11, 2, 2, 2)
    np.testing.assert_allclose(g_el[..., 0], g_full[..., 0, 0], atol=1e-12)
    np.testing.assert_allclose(g_el[..., 1], g_full[..., 0, 1], atol=1e-12)


@pytest.mark.driver
def test_itcf_stack_size(tmp_path):
    """stack_size subsamples G(tau) at stack boundaries: the kept slices
    must equal the corresponding slices of a stack_size=1 run exactly
    (``pauxy/estimators/itcf.py:85-89``)."""
    import os, sys
    if not os.path.isdir("/root/reference/pauxy"):
        pytest.skip("no reference tooling")
    sys.path.insert(0, "/root/reference")
    from pauxy.analysis.extraction import extract_data

    ham = make_hubbard(nup=3, ndown=3, U=4.0, nx=3, ny=3)
    trial = free_electron_trial(ham)
    qmc = QMCOpts(nwalkers=8, dt=0.01, nsteps=8, nblocks=2, nstblz=4,
                  npop_control=4, rng_seed=8)
    gs = {}
    for ss in (1, 2):
        fn = str(tmp_path / f"ss{ss}.h5")
        af = AFQMC(ham, trial, qmc,
                   estimator_options={
                       "mixed": {"energy_eval_freq": 1},
                       "itcf": {"tau_max": 0.08, "stack_size": ss},
                   },
                   filename=fn)
        af.run()
        gs[ss] = extract_data(fn, "itcf", "real_space_greens_function",
                              raw=True)
    assert gs[2].shape[1] == 5      # nmax//2 + 1 = 8//2 + 1
    np.testing.assert_allclose(gs[2], gs[1][:, ::2], atol=1e-10)


@pytest.mark.driver
def test_itcf_generic_free_fermions(tmp_path):
    """ITCF through the Generic/Cholesky continuous propagator: with all
    Cholesky vectors zero the dynamics is exactly free, so the same
    analytic oracle applies — exercises dense_propagators' continuous
    branch on an ab-initio Hamiltonian (the reference's ITCF is
    system-general the same way)."""
    from pauxy_jax.models.generic import make_generic
    from pauxy_jax.models.trial import trial_from_orbitals

    rng = np.random.default_rng(5)
    m = 6
    h1 = rng.normal(scale=0.3, size=(m, m))
    h1 = 0.5 * (h1 + h1.T)
    ham = make_generic((2, 2), np.stack([h1, h1]),
                       np.zeros((m, m, 1)), ecore=0.0)
    _, v = np.linalg.eigh(h1)
    psi = np.concatenate([v[:, :2], v[:, :2]], axis=1).astype(np.complex128)
    trial = trial_from_orbitals(ham, psi)

    ntau, dt = 4, 0.05
    qmc = QMCOpts(nwalkers=4, dt=dt, nsteps=ntau, nblocks=2, nstblz=100,
                  npop_control=100, rng_seed=3)
    af = AFQMC(
        ham, trial, qmc,
        estimator_options={
            "mixed": {"energy_eval_freq": 1},
            "itcf": {"tau_max": ntau * dt, "stable": True},
        },
        filename=str(tmp_path / "itcfgen.h5"),
    )
    af.run()

    import h5py

    with h5py.File(str(tmp_path / "itcfgen.h5"), "r") as fh5:
        keys = sorted(fh5["itcf/real_space_greens_function"].keys())
        spgf = fh5[f"itcf/real_space_greens_function/{keys[-1]}"][:]
    p = psi[:, :2] @ np.linalg.inv(psi[:, :2].conj().T @ psi[:, :2]) \
        @ psi[:, :2].conj().T
    for n in range(ntau + 1):
        bgr = scipy.linalg.expm(-n * dt * h1)
        bls = scipy.linalg.expm(n * dt * h1)
        np.testing.assert_allclose(spgf[n, 0, 0],
                                   (bgr @ (np.eye(m) - p)).real, atol=1e-8)
        np.testing.assert_allclose(spgf[n, 0, 1], (p @ bls).real, atol=1e-8)


@pytest.mark.driver
def test_itcf_long_tau_stable_vs_unstable(tmp_path):
    """tau_max=5 at U=0: the greater function spans e^{-tau e_k} over
    e_k in [-4, 2] — a ~1e13 dynamic range where the naive B-product
    accumulation loses the small components. The stable Feldbacher-Assaad
    path must track the analytic result to 1e-6; this is the long-tau
    counterpart of the long-beta thermal stability tests."""
    ham = make_hubbard(nup=3, ndown=3, U=0.0, nx=3, ny=3)
    trial = free_electron_trial(ham)
    ntau, dt = 100, 0.05
    qmc = QMCOpts(nwalkers=2, dt=dt, nsteps=ntau, nblocks=1, nstblz=10,
                  npop_control=1000, rng_seed=3)
    af = AFQMC(
        ham, trial, qmc,
        estimator_options={
            "mixed": {"energy_eval_freq": 10},
            "itcf": {"tau_max": ntau * dt, "stable": True},
        },
        filename=str(tmp_path / "itcflong.h5"),
    )
    af.run()

    import h5py

    with h5py.File(str(tmp_path / "itcflong.h5"), "r") as fh5:
        keys = sorted(fh5["itcf/real_space_greens_function"].keys())
        spgf = fh5[f"itcf/real_space_greens_function/{keys[-1]}"][:]
    ref = analytic_free_itcf(ham, trial, dt, ntau)
    for n in (0, 20, 50, 100):
        np.testing.assert_allclose(spgf[n, 0, 0], ref[n, 0].real, atol=1e-6,
                                   err_msg=f"Ggr tau={n * dt}")
        np.testing.assert_allclose(spgf[n, 0, 1], ref[n, 1].real, atol=1e-6,
                                   err_msg=f"Gls tau={n * dt}")
