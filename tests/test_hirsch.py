"""Discrete Hirsch propagator: sweep vs independent numpy implementation and
statistical driver regression vs reference golden data."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pauxy_jax.models import make_hubbard, free_electron_trial
from pauxy_jax.models.trial import trial_from_orbitals
from pauxy_jax.propagation.hirsch import make_hirsch
from pauxy_jax.qmc import AFQMC, QMCOpts
from pauxy_jax.walkers import init_walkers

DATA = os.path.join(os.path.dirname(__file__), "data")


def numpy_sweep(trial, auxf, aux_wfac, phia, phib, rs_site):
    """Independent single-walker site sweep with full recomputation per site
    (no Sherman-Morrison) — the dense oracle of the reference's unit tests
    (cf. pauxy/propagation/tests/test_hubbard.py:30-85 style)."""
    psia, psib = np.asarray(trial.psia), np.asarray(trial.psib)
    delta = np.asarray(auxf) - 1.0
    m = phia.shape[0]
    weight_fac = 1.0
    log_ot = 0.0 + 0j
    phia, phib = phia.copy(), phib.copy()
    for i in range(m):
        # G_ii = psi*[i] (S^-1)^T phi[i]  with S = psi^dag phi.
        sa = psia.conj().T @ phia
        sb = psib.conj().T @ phib
        ga = psia.conj()[i] @ (np.linalg.inv(sa).T @ phia[i])
        gb = psib.conj()[i] @ (np.linalg.inv(sb).T @ phib[i])
        r1 = (1 + delta[0, 0] * ga) * (1 + delta[0, 1] * gb)
        r2 = (1 + delta[1, 0] * ga) * (1 + delta[1, 1] * gb)
        probs = 0.5 * np.array([r1, r2]) * np.asarray(aux_wfac)
        pr = np.maximum(probs.real, 0)
        norm = pr.sum()
        assert norm > 0
        weight_fac *= norm
        xi = 0 if rs_site[i] < pr[0] / norm else 1
        log_ot += np.log(2 * probs[xi])
        phia[i] *= 1 + delta[xi, 0]
        phib[i] *= 1 + delta[xi, 1]
    return phia, phib, weight_fac, log_ot


@pytest.mark.unit
@pytest.mark.parametrize("charge,kernel", [
    (False, "scan"), (True, "scan"), (False, "triton_interpret"),
])
def test_site_sweep_vs_numpy(charge, kernel):
    ham = make_hubbard(nup=3, ndown=3, U=4.0, nx=3, ny=3)
    trial = free_electron_trial(ham)
    prop = make_hirsch(ham, trial, dt=0.05, charge_decomposition=charge,
                       sweep_kernel=kernel)
    nw = 4
    state = init_walkers(trial, nw)
    # Randomize walker states a bit (still full rank). The kernel's
    # contract is the real subspace (driver-built discrete runs stay real),
    # so its perturbation is real; the scan path also covers complex states.
    rng = np.random.default_rng(0)
    pert = 0.1 * rng.standard_normal(state.phia.shape)
    if kernel == "scan":
        pert = pert + 0.1j * rng.standard_normal(state.phia.shape)
    state = state.replace(phia=state.phia + pert, phib=state.phib + pert)

    key = jax.random.key(3)
    new, _fields = prop._site_sweep(trial, state, key)

    rs = np.asarray(
        jax.random.uniform(key, (ham.nbasis, nw), dtype=jnp.float64)
    )
    for w in range(nw):
        pa, pb, wf, dlog = numpy_sweep(
            trial, prop.auxf, prop.aux_wfac,
            np.asarray(state.phia[w]), np.asarray(state.phib[w]), rs[:, w],
        )
        np.testing.assert_allclose(np.asarray(new.phia[w]), pa, atol=1e-10)
        np.testing.assert_allclose(np.asarray(new.phib[w]), pb, atol=1e-10)
        np.testing.assert_allclose(float(new.weight[w]), wf, rtol=1e-9)
        got = complex(new.log_ovlp[w] - state.log_ovlp[w])
        assert abs(np.exp(got) - np.exp(dlog)) / abs(np.exp(dlog)) < 1e-8


@pytest.mark.unit
def test_sweep_overlap_consistency():
    """log_ovlp tracked through the sweep equals the recomputed overlap."""
    from pauxy_jax.ops import greens

    ham = make_hubbard(nup=3, ndown=3, U=4.0, nx=3, ny=3)
    trial = free_electron_trial(ham)
    prop = make_hirsch(ham, trial, dt=0.05)
    state = init_walkers(trial, 3)
    new, _ = prop._site_sweep(trial, state, jax.random.key(11))
    fresh = greens.log_overlap(new.phia, trial.psia) + greens.log_overlap(
        new.phib, trial.psib
    )
    ratio = np.asarray(new.log_ovlp - fresh)
    np.testing.assert_allclose(ratio.real, 0, atol=1e-9)
    np.testing.assert_allclose(
        np.mod(np.abs(ratio.imag) + np.pi, 2 * np.pi) - np.pi, 0, atol=1e-8
    )


@pytest.mark.driver
def test_hubbard_4x4_discrete_vs_reference_golden(tmp_path):
    """4x4 Hubbard U=4 (7,7), UHF trial, discrete HS, dt=0.01 — golden series
    from the reference with identical trial orbitals (pinned short-run mean:
    -14.97, test_afqmc.py:140-143)."""
    path = os.path.join(DATA, "hubbard4x4_uhf_discrete.npz")
    if not os.path.exists(path):
        pytest.skip("golden data missing")
    g = np.load(path)
    ham = make_hubbard(nup=7, ndown=7, U=4.0, nx=4, ny=4)
    trial = trial_from_orbitals(ham, np.asarray(g["psi"]))
    qmc = QMCOpts(
        nwalkers=int(g["nwalkers"]), dt=float(g["dt"]), nsteps=int(g["nsteps"]),
        nblocks=100, nstblz=10, npop_control=1, rng_seed=8,
    )
    af = AFQMC(
        ham, trial, qmc,
        propagator_options={"hubbard_stratonovich": "discrete"},
        estimator_options={"mixed": {"energy_eval_freq": 1}},
        filename=str(tmp_path / "d.h5"),
    )
    rows = af.run()
    et = rows[:, 5].real
    ref = np.asarray(g["etotal_blocks"])
    mine, theirs = et[len(et) // 3 :], ref[len(ref) // 3 :]
    se = np.hypot(
        mine.std(ddof=1) / np.sqrt(len(mine)),
        theirs.std(ddof=1) / np.sqrt(len(theirs)),
    )
    diff = abs(mine.mean() - theirs.mean())
    assert diff < max(4 * se, 0.05), (mine.mean(), theirs.mean(), se)


@pytest.mark.unit
def test_kinetic_kspace_matches_dense():
    """FFT kinetic application must equal the dense BT2 matmul on a clean
    PBC lattice (``pauxy/propagation/hubbard.py:800-833``)."""
    import jax.numpy as jnp
    from pauxy_jax.propagation.hirsch import make_hirsch

    ham = make_hubbard(nup=3, ndown=3, U=4.0, nx=4, ny=4)
    trial = free_electron_trial(ham)
    dense = make_hirsch(ham, trial, dt=0.05)
    kspace = make_hirsch(ham, trial, dt=0.05, kinetic_kspace=True)
    rng = np.random.default_rng(2)
    phi = jnp.asarray(
        rng.standard_normal((3, ham.nbasis, 3))
        + 1j * rng.standard_normal((3, ham.nbasis, 3))
    )
    want = np.einsum("pm,wmn->wpn", np.asarray(dense.BT2[0]), np.asarray(phi))
    got = np.asarray(kspace._apply_bt2(phi))
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.unit
def test_kinetic_kspace_rejects_twist():
    from pauxy_jax.propagation.hirsch import make_hirsch

    ham = make_hubbard(nup=3, ndown=3, U=4.0, nx=3, ny=3,
                       ktwist=[0.1, 0.2])
    trial = free_electron_trial(ham)
    with pytest.raises(ValueError):
        make_hirsch(ham, trial, dt=0.05, kinetic_kspace=True)


@pytest.mark.driver
def test_two_body_direct_driver(tmp_path):
    """Whole-lattice dynamic-force-bias update: same physics as the
    single-site sweep statistically (both are exact discrete HS samplers of
    the same propagator; only the importance function differs)."""
    from pauxy_jax.qmc import AFQMC, QMCOpts

    ham = make_hubbard(nup=3, ndown=3, U=4.0, nx=3, ny=3)
    trial = free_electron_trial(ham)
    # The direct update is the reference's high-variance sampler
    # (hubbard.py:222 "dynamic force bias"): per-step pop control (the
    # CPMC standard) keeps the population alive; sparser control lets a
    # small population die outright (caught by the driver's liveness
    # abort).
    qmc = QMCOpts(nwalkers=64, dt=0.01, nsteps=10, nblocks=40, nstblz=5,
                  npop_control=1, rng_seed=8)
    means = {}
    for mode in ("single_site", "direct"):
        af = AFQMC(ham, trial, qmc,
                   propagator_options={"hubbard_stratonovich": "discrete",
                                       "two_body_update": mode,
                                       "kinetic_kspace": mode == "direct"},
                   estimator_options={"mixed": {"energy_eval_freq": 1}},
                   filename=str(tmp_path / f"{mode}.h5"))
        rows = af.run()
        et = rows[:, 5].real
        assert np.isfinite(et).all()
        means[mode] = et[len(et) // 3:]
    a, b = means["single_site"], means["direct"]
    se = np.hypot(a.std(ddof=1) / np.sqrt(len(a)),
                  b.std(ddof=1) / np.sqrt(len(b)))
    assert abs(a.mean() - b.mean()) < max(5 * se, 0.1), (
        a.mean(), b.mean(), se)


@pytest.mark.unit
def test_single_site_update_false_alias(tmp_path):
    """The reference's 'single_site_update': false spelling selects the
    whole-lattice dynamic-force-bias update (propagation/hubbard.py:49)."""
    from pauxy_jax.models import make_hubbard, free_electron_trial
    from pauxy_jax.qmc import AFQMC, QMCOpts

    ham = make_hubbard(nup=2, ndown=2, U=4.0, nx=2, ny=2)
    trial = free_electron_trial(ham)
    qmc = QMCOpts(nwalkers=4, dt=0.01, nsteps=2, nblocks=1, rng_seed=1)
    af = AFQMC(ham, trial, qmc,
               propagator_options={"hubbard_stratonovich": "discrete",
                                   "single_site_update": False},
               filename=str(tmp_path / "alias.h5"))
    assert af.prop.two_body_mode == "direct"
    af2 = AFQMC(ham, trial, qmc,
                propagator_options={"hubbard_stratonovich": "discrete"},
                filename=str(tmp_path / "alias2.h5"))
    assert af2.prop.two_body_mode == "single_site"


@pytest.mark.unit
def test_attractive_u_discrete(tmp_path):
    """Attractive U: the charge decomposition runs (pairing-favored energy
    below the U=0 value); the spin decomposition raises a clear error
    instead of NaN-ing (arccosh of e^{dt U/2} < 1 is complex — the
    reference silently produces NaN fields here)."""
    import numpy as np

    from pauxy_jax.models import make_hubbard, free_electron_trial
    from pauxy_jax.qmc import AFQMC, QMCOpts

    ham = make_hubbard(nup=3, ndown=3, U=-4.0, nx=3, ny=3)
    trial = free_electron_trial(ham)
    qmc = QMCOpts(nwalkers=64, dt=0.005, nsteps=5, nblocks=2, rng_seed=1,
                  npop_control=1)
    af = AFQMC(ham, trial, qmc,
               propagator_options={"hubbard_stratonovich": "discrete",
                                   "charge_decomposition": True},
               filename=str(tmp_path / "attr.h5"))
    rows = np.asarray(af.run())
    assert np.isfinite(rows.real).all()
    e_free = np.sort(np.linalg.eigvalsh(np.asarray(ham.T)[0]))[:3].sum() * 2
    assert rows[-1, 5].real < e_free  # attraction lowers the energy

    # Quantitative window vs FCI on a 4-site chain (charge decomposition is
    # the real-field HS for attractive U): short run, so allow
    # constrained-path + Trotter bias (~22 mHa measured at dt=0.01).
    from pauxy_jax.estimators import ci

    ham4 = make_hubbard(nup=2, ndown=2, U=-4.0, nx=4, xpbc=False)
    ev, _, _ = ci.simple_fci(ham4)
    t4 = free_electron_trial(ham4)
    qmc4 = QMCOpts(nwalkers=128, dt=0.01, nsteps=10, nblocks=60, nstblz=5,
                   npop_control=1, rng_seed=8)
    af4 = AFQMC(ham4, t4, qmc4,
                propagator_options={"hubbard_stratonovich": "discrete",
                                    "charge_decomposition": True},
                estimator_options={"mixed": {"energy_eval_freq": 1}},
                filename=str(tmp_path / "attr_fci.h5"))
    et = np.asarray(af4.run())[20:, 5].real
    assert abs(et.mean() - ev[0]) < 0.05, (et.mean(), ev[0])

    with pytest.raises(ValueError, match="charge_decomposition"):
        AFQMC(ham, trial, qmc,
              propagator_options={"hubbard_stratonovich": "discrete"},
              filename=str(tmp_path / "attr2.h5"))


def _real_walkers(trial, nw, seed):
    state = init_walkers(trial, nw)
    rng = np.random.default_rng(seed)
    return state.replace(
        phia=state.phia + 0.1 * rng.standard_normal(state.phia.shape),
        phib=state.phib + 0.1 * rng.standard_normal(state.phib.shape))


@pytest.mark.unit
@pytest.mark.parametrize("nx,ny,nup,ndown,nw", [
    (3, 3, 3, 3, 4),       # padded sites (9 -> 16) and orbitals (3 -> 4)
    (4, 4, 7, 7, 40),      # the 4x4 flagship; two walker blocks, padded
    (4, 4, 7, 5, 33),      # unequal spins
])
def test_triton_sweep_matches_scan(nx, ny, nup, ndown, nw):
    """The site-sweep kernel (interpret mode) follows the scan sweep's
    trajectory: same fields, weights, overlaps and walkers."""
    ham = make_hubbard(nup=nup, ndown=ndown, U=4.0, nx=nx, ny=ny)
    trial = free_electron_trial(ham)
    scan = make_hirsch(ham, trial, dt=0.05, sweep_kernel="scan")
    kern = make_hirsch(ham, trial, dt=0.05, sweep_kernel="triton_interpret")
    state = _real_walkers(trial, nw, 1)
    key = jax.random.key(5)
    s1, f1 = scan._site_sweep(trial, state, key)
    s2, f2 = kern._site_sweep(trial, state, key)
    np.testing.assert_array_equal(np.asarray(f1), np.asarray(f2))
    for a, b in ((s1.weight, s2.weight), (s1.log_ovlp, s2.log_ovlp),
                 (s1.phia, s2.phia), (s1.phib, s2.phib)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-10, atol=1e-12)


@pytest.mark.unit
@pytest.mark.parametrize("backend,popts,expect", [
    ("cpu", {}, "scan"),
    ("gpu", {}, "triton"),
    ("gpu", {"charge_decomposition": True}, "scan"),
    ("gpu", {"free_projection": True}, "scan"),
    ("gpu", {"two_body_mode": "direct"}, "scan"),
    ("gpu", {"ktwist": [0.01, 0.0]}, "scan"),
])
def test_sweep_kernel_choice(monkeypatch, backend, popts, expect):
    """The kernel is chosen from the platform and the propagation's
    realness; the CPU never gets it (and so never interpret mode)."""
    from pauxy_jax.propagation import hirsch

    popts = dict(popts)
    ham = make_hubbard(nup=3, ndown=3, U=4.0, nx=3, ny=3,
                       ktwist=popts.pop("ktwist", None))
    trial = free_electron_trial(ham)
    monkeypatch.setattr(hirsch.jax, "default_backend", lambda: backend)
    assert make_hirsch(ham, trial, 0.05, **popts).sweep_kernel == expect


@pytest.mark.driver
def test_triton_sweep_driver_trajectory(tmp_path):
    """A discrete driver run with the kernel (interpret mode) reproduces
    the scan run's rows."""
    from pauxy_jax.qmc import AFQMC, QMCOpts

    ham = make_hubbard(nup=3, ndown=3, U=4.0, nx=3, ny=3)
    trial = free_electron_trial(ham)
    qmc = QMCOpts(nwalkers=8, dt=0.05, nsteps=4, nblocks=2, nstblz=2,
                  npop_control=2, rng_seed=3)
    rows = [AFQMC(ham, trial, qmc, filename=False, propagator_options={
        "hubbard_stratonovich": "discrete", "sweep_kernel": k}).run()
        for k in ("scan", "triton_interpret")]
    np.testing.assert_allclose(rows[0][:, 1:10].real, rows[1][:, 1:10].real,
                               rtol=1e-9, atol=1e-10)
