"""Multi-(virtual)-device tests: sharded walker axis over an 8-device CPU mesh.

Replaces the reference's mpiexec-based parallel CI (SURVEY.md section 4) with
the XLA host-platform device-count trick.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pauxy_jax.models import make_hubbard, free_electron_trial
from pauxy_jax.parallel import mesh as pmesh
from pauxy_jax.qmc import AFQMC, QMCOpts
from pauxy_jax.walkers import init_walkers
from pauxy_jax.walkers import pop_control as pc

pytestmark = pytest.mark.integration

NDEV = len(jax.devices())


@pytest.mark.skipif(NDEV < 2, reason="needs multiple devices")
def test_sharded_block_matches_single_device(tmp_path):
    """The jitted block program must give identical physics whether the
    walker axis lives on 1 device or is sharded over 8."""
    ham = make_hubbard(nup=3, ndown=3, U=4.0, nx=3, ny=3, ktwist=[0.01, -0.02])
    trial = free_electron_trial(ham)
    qmc = QMCOpts(nwalkers=16, dt=0.01, nsteps=10, nblocks=3, nstblz=5,
                  npop_control=2, rng_seed=11)

    af1 = AFQMC(ham, trial, qmc,
                estimator_options={"mixed": {"energy_eval_freq": 1}},
                filename=str(tmp_path / "a.h5"))
    rows1 = af1.run()

    af2 = AFQMC(ham, trial, qmc,
                estimator_options={"mixed": {"energy_eval_freq": 1}},
                filename=str(tmp_path / "b.h5"))
    m = pmesh.walker_mesh()
    af2.state = pmesh.shard_walkers(af2.state, m)
    rows2 = af2.run()

    np.testing.assert_allclose(rows1[:, 1:10].real, rows2[:, 1:10].real,
                               rtol=1e-8, atol=1e-10)


@pytest.mark.skipif(NDEV < 2, reason="needs multiple devices")
def test_comb_gather_across_devices():
    """comb's parent gather crosses device boundaries correctly."""
    ham = make_hubbard(nup=2, ndown=2, U=4.0, nx=2, ny=2)
    trial = free_electron_trial(ham)
    nw = 16
    state = init_walkers(trial, nw)
    tags = jnp.arange(nw, dtype=state.phia.dtype)
    # all weight on walker 3 (device 1 for 8 devices x 2 walkers)
    w = np.full(nw, 1e-6)
    w[3] = 1.0
    state = state.replace(
        phia=state.phia.at[:, 0, 0].set(tags),
        weight=jnp.asarray(w, state.weight.dtype),
    )
    m = pmesh.walker_mesh()
    state = pmesh.shard_walkers(state, m)
    out = jax.jit(lambda s, k: pc.comb(s, k, float(nw)))(state, jax.random.key(0))
    got = np.round(np.asarray(out.phia[:, 0, 0]).real).astype(int)
    assert np.all(got == 3)
    np.testing.assert_allclose(np.asarray(out.weight), 1.0)


@pytest.mark.skipif(NDEV < 8, reason="needs 8 devices")
def test_generic_chol_sharded_matches_single_device(tmp_path):
    """Generic run with the Cholesky axis sharded over a [walker=2, chol=4]
    mesh gives identical physics to the unsharded run (SURVEY 2.11:
    chol-axis sharding with psum-completed contractions)."""
    from pauxy_jax.models.generic import make_generic
    from pauxy_jax.models.trial import rhf_identity_trial
    from pauxy_jax.utils.testing import generate_hamiltonian

    h1e, chol, enuc, _ = generate_hamiltonian(8, (3, 3), seed=5, nchol=16)
    ham = make_generic((3, 3), h1e, chol, enuc)
    trial = rhf_identity_trial(ham)
    qmc = QMCOpts(nwalkers=16, dt=0.005, nsteps=8, nblocks=2, nstblz=4,
                  npop_control=2, rng_seed=3)

    af1 = AFQMC(ham, trial, qmc,
                estimator_options={"mixed": {"energy_eval_freq": 1}},
                filename=str(tmp_path / "g1.h5"))
    rows1 = af1.run()

    af2 = AFQMC(ham, trial, qmc,
                estimator_options={"mixed": {"energy_eval_freq": 1}},
                filename=str(tmp_path / "g2.h5"))
    m2 = pmesh.walker_chol_mesh(4)
    sham, strial, sprop = pmesh.shard_generic(af2.ham, af2.trial, af2.prop, m2)
    af2.ham, af2.trial, af2.prop = sham, strial, sprop
    af2.state = pmesh.shard_walkers(af2.state, m2)
    rows2 = af2.run()

    np.testing.assert_allclose(rows1[:, 1:10].real, rows2[:, 1:10].real,
                               rtol=1e-8, atol=1e-10)


@pytest.mark.skipif(NDEV < 8, reason="needs 8 devices")
def test_msd_generic_chol_sharded(tmp_path):
    """MSD trial with per-det rchol sharded over the chol axis."""
    from pauxy_jax.models.generic import make_generic
    from pauxy_jax.models.multi_slater import multi_slater_trial
    from pauxy_jax.utils.testing import generate_hamiltonian

    h1e, chol, enuc, _ = generate_hamiltonian(8, (3, 3), seed=5, nchol=16)
    ham = make_generic((3, 3), h1e, chol, enuc)
    rng = np.random.default_rng(4)
    eye = np.eye(8)[:, :6]
    psi = np.stack([eye, eye + 0.05 * rng.standard_normal(eye.shape)])
    trial = multi_slater_trial(ham, psi, np.array([0.9, 0.1]))
    qmc = QMCOpts(nwalkers=16, dt=0.005, nsteps=6, nblocks=2, nstblz=3,
                  npop_control=2, rng_seed=9)

    af1 = AFQMC(ham, trial, qmc,
                estimator_options={"mixed": {"energy_eval_freq": 1}},
                filename=str(tmp_path / "m1.h5"))
    rows1 = af1.run()

    af2 = AFQMC(ham, trial, qmc,
                estimator_options={"mixed": {"energy_eval_freq": 1}},
                filename=str(tmp_path / "m2.h5"))
    m2 = pmesh.walker_chol_mesh(4)
    af2.ham, af2.trial, af2.prop = pmesh.shard_generic(
        af2.ham, af2.trial, af2.prop, m2
    )
    af2.state = pmesh.shard_walkers(af2.state, m2)
    rows2 = af2.run()

    np.testing.assert_allclose(rows1[:, 1:10].real, rows2[:, 1:10].real,
                               rtol=1e-8, atol=1e-10)


@pytest.mark.skipif(NDEV < 2, reason="needs multiple devices")
def test_pair_branch_sharded_matches_single_device(tmp_path):
    """pair_branch (argsort + gather pairing) under a sharded walker axis:
    identical physics to the unsharded run (the reference's rank-paired
    branching, pauxy/walkers/handler.py:258-318, as SPMD gathers)."""
    ham = make_hubbard(nup=3, ndown=3, U=4.0, nx=3, ny=3,
                       ktwist=[0.01, -0.02])
    trial = free_electron_trial(ham)
    qmc = QMCOpts(nwalkers=16, dt=0.01, nsteps=10, nblocks=3, nstblz=5,
                  npop_control=2, rng_seed=11,
                  pop_control_method="pair_branch")

    af1 = AFQMC(ham, trial, qmc,
                estimator_options={"mixed": {"energy_eval_freq": 1}},
                filename=str(tmp_path / "p1.h5"))
    rows1 = af1.run()

    af2 = AFQMC(ham, trial, qmc,
                estimator_options={"mixed": {"energy_eval_freq": 1}},
                filename=str(tmp_path / "p2.h5"))
    af2.state = pmesh.shard_walkers(af2.state, pmesh.walker_mesh())
    rows2 = af2.run()

    np.testing.assert_allclose(rows1[:, 1:10].real, rows2[:, 1:10].real,
                               rtol=1e-8, atol=1e-10)


@pytest.mark.skipif(NDEV < 2, reason="needs multiple devices")
def test_discrete_hirsch_sharded_matches_single_device(tmp_path):
    """Discrete Hirsch CPMC (scan sweep) with the walker axis sharded."""
    ham = make_hubbard(nup=3, ndown=3, U=4.0, nx=3, ny=3)
    trial = free_electron_trial(ham)
    qmc = QMCOpts(nwalkers=16, dt=0.05, nsteps=6, nblocks=3, nstblz=3,
                  npop_control=2, rng_seed=5)
    popts = {"hubbard_stratonovich": "discrete"}

    af1 = AFQMC(ham, trial, qmc, propagator_options=popts,
                estimator_options={"mixed": {"energy_eval_freq": 1}},
                filename=str(tmp_path / "d1.h5"))
    rows1 = af1.run()

    af2 = AFQMC(ham, trial, qmc, propagator_options=popts,
                estimator_options={"mixed": {"energy_eval_freq": 1}},
                filename=str(tmp_path / "d2.h5"))
    af2.state = pmesh.shard_walkers(af2.state, pmesh.walker_mesh())
    rows2 = af2.run()

    np.testing.assert_allclose(rows1[:, 1:10].real, rows2[:, 1:10].real,
                               rtol=1e-8, atol=1e-10)


@pytest.mark.skipif(NDEV < 2, reason="needs multiple devices")
def test_thermal_sharded_matches_single_device(tmp_path):
    """Thermal AFQMC (per-slice pop control over a sharded stack) gives
    identical physics sharded vs unsharded (reference per-slice pop control,
    pauxy/qmc/thermal_afqmc.py:224-226)."""
    from pauxy_jax.models.thermal_trial import make_one_body_trial
    from pauxy_jax.qmc.thermal_afqmc import ThermalAFQMC

    ham = make_hubbard(nup=3, ndown=3, U=4.0, nx=3, ny=3)
    beta, dt = 0.5, 0.05
    trial = make_one_body_trial(ham, beta, dt)
    qmc = QMCOpts(nwalkers=16, dt=dt, nsteps=1, nblocks=4, beta=beta,
                  npop_control=2, rng_seed=7)

    af1 = ThermalAFQMC(ham, trial, qmc, filename=str(tmp_path / "t1.h5"))
    rows1 = af1.run()

    af2 = ThermalAFQMC(ham, trial, qmc, filename=str(tmp_path / "t2.h5"))
    m = pmesh.walker_mesh()
    inner_init = af2._init_walkers

    def sharded_init(trial, nw):
        return pmesh.shard_walkers(inner_init(trial, nw), m)

    af2._init_walkers = sharded_init
    af2.state = pmesh.shard_walkers(af2.state, m)
    rows2 = af2.run()

    # All columns except the wall-clock Time tail.
    np.testing.assert_allclose(rows1[:, :11].real, rows2[:, :11].real,
                               rtol=1e-8, atol=1e-10)


@pytest.mark.skipif(NDEV < 2, reason="needs multiple devices")
def test_thermal_discrete_sharded_matches_single_device(tmp_path):
    """ThermalDiscrete (finite-T Hirsch, G <- B G B^-1 rank-1 updates)
    with the walker axis sharded matches single-device (reference:
    pauxy/thermal_propagation/hubbard.py:8-180)."""
    from pauxy_jax.models.thermal_trial import make_one_body_trial
    from pauxy_jax.qmc.thermal_afqmc import ThermalAFQMC

    ham = make_hubbard(nup=2, ndown=2, U=4.0, nx=2, ny=2)
    beta, dt = 0.5, 0.05
    trial = make_one_body_trial(ham, beta, dt)
    qmc = QMCOpts(nwalkers=16, dt=dt, nsteps=1, nblocks=3, beta=beta,
                  npop_control=2, rng_seed=3)
    popts = {"hubbard_stratonovich": "discrete"}

    af1 = ThermalAFQMC(ham, trial, qmc, propagator_options=popts,
                       filename=str(tmp_path / "td1.h5"))
    rows1 = af1.run()

    af2 = ThermalAFQMC(ham, trial, qmc, propagator_options=popts,
                       filename=str(tmp_path / "td2.h5"))
    m = pmesh.walker_mesh()
    inner_init = af2._init_walkers

    def sharded_init(trial, nw):
        return pmesh.shard_walkers(inner_init(trial, nw), m)

    af2._init_walkers = sharded_init
    af2.state = pmesh.shard_walkers(af2.state, m)
    rows2 = af2.run()

    np.testing.assert_allclose(rows1[:, :11].real, rows2[:, :11].real,
                               rtol=1e-8, atol=1e-10)


@pytest.mark.skipif(NDEV < 2, reason="needs multiple devices")
def test_hubbard_holstein_sharded_matches_single_device(tmp_path):
    """HirschDMC (discrete Hirsch + phonon DMC moves) with the walker axis
    sharded: the phonon coordinate arrays, the boson importance-sampling
    acceptance draws, and the coupled electron update must be SPMD-clean
    (reference: pauxy/propagation/hubbard_holstein.py:17-440)."""
    from pauxy_jax.models.hubbard_holstein import (coherent_state_trial,
                                                   make_hubbard_holstein)

    ham = make_hubbard_holstein(nup=2, ndown=2, U=4.0, nx=4, g=0.5, w0=1.0,
                                xpbc=False)
    trial = coherent_state_trial(ham)
    qmc = QMCOpts(nwalkers=16, dt=0.01, nsteps=8, nblocks=3, nstblz=4,
                  npop_control=4, rng_seed=5)

    af1 = AFQMC(ham, trial, qmc,
                estimator_options={"mixed": {"energy_eval_freq": 2}},
                filename=str(tmp_path / "hh1.h5"))
    rows1 = af1.run()

    af2 = AFQMC(ham, trial, qmc,
                estimator_options={"mixed": {"energy_eval_freq": 2}},
                filename=str(tmp_path / "hh2.h5"))
    af2.state = pmesh.shard_walkers(af2.state, pmesh.walker_mesh())
    rows2 = af2.run()

    np.testing.assert_allclose(rows1[:, 1:10].real, rows2[:, 1:10].real,
                               rtol=1e-8, atol=1e-10)


@pytest.mark.skipif(NDEV < 2, reason="needs multiple devices")
def test_thermal_lowrank_sharded_matches_single_device(tmp_path):
    """Low-rank thermal UEG (masked QDT stack) sharded on the walker axis
    matches the unsharded run (reference low-rank path,
    pauxy/thermal_propagation/planewave.py:519 + walkers/stack.py:326)."""
    from pauxy_jax.qmc.calc import setup_calculation

    def build(fname):
        return setup_calculation({
            "verbosity": 0,
            "qmc": {"timestep": 0.05, "rng_seed": 8, "nblocks": 3,
                    "nwalkers": 16, "beta": 0.25, "npop_control": 2},
            "model": {"name": "UEG", "rs": 1.0, "ecut": 1.0, "nup": 1,
                      "mu": 0.245, "ndown": 1},
            "trial": {"name": "one_body"},
            "walkers": {"low_rank": True, "low_rank_thresh": 1e-6},
            "estimates": {"filename": str(tmp_path / fname)},
        })

    af1 = build("lr1.h5")
    rows1 = af1.run()

    af2 = build("lr2.h5")
    m = pmesh.walker_mesh()
    inner_init = af2._init_walkers

    def sharded_init(trial, nw):
        return pmesh.shard_walkers(inner_init(trial, nw), m)

    af2._init_walkers = sharded_init
    af2.state = pmesh.shard_walkers(af2.state, m)
    rows2 = af2.run()

    np.testing.assert_allclose(rows1[:, :11].real, rows2[:, :11].real,
                               rtol=1e-8, atol=1e-10)


@pytest.mark.skipif(NDEV < 2, reason="needs multiple devices")
def test_bp_sharded_matches_single_device(tmp_path):
    """Back-propagation under a sharded walker axis: the in-scan field-config
    history ring buffer, the reverse BP scan, and the psum'd BP accumulators
    must give identical physics sharded vs unsharded (VERDICT r2 weak #4:
    BP history gathers were untested SPMD surface). Reference collective:
    comm.Reduce in pauxy/estimators/back_propagation.py:269-326."""
    import h5py

    ham = make_hubbard(nup=3, ndown=3, U=4.0, nx=3, ny=3)
    trial = free_electron_trial(ham)
    qmc = QMCOpts(nwalkers=16, dt=0.01, nsteps=10, nblocks=3, nstblz=5,
                  npop_control=5, rng_seed=8)
    eopts = {
        "mixed": {"energy_eval_freq": 1},
        "back_propagation": {"tau_bp": 0.1, "evaluate_energy": True},
    }

    af1 = AFQMC(ham, trial, qmc, estimator_options=eopts,
                filename=str(tmp_path / "bp1.h5"))
    rows1 = af1.run()

    af2 = AFQMC(ham, trial, qmc, estimator_options=eopts,
                filename=str(tmp_path / "bp2.h5"))
    af2.state = pmesh.shard_walkers(af2.state, pmesh.walker_mesh())
    rows2 = af2.run()

    np.testing.assert_allclose(rows1[:, 1:10].real, rows2[:, 1:10].real,
                               rtol=1e-8, atol=1e-10)
    out = []
    for f in ("bp1.h5", "bp2.h5"):
        with h5py.File(str(tmp_path / f), "r") as fh5:
            grp = fh5["back_propagated"]
            en_key = [k for k in grp if k.startswith("energies")][0]
            ens = np.stack([grp[en_key][k][:] for k in sorted(grp[en_key])])
            rdm_key = [k for k in grp if k.startswith("one_rdm")][0]
            rdms = np.stack([grp[rdm_key][k][:] for k in sorted(grp[rdm_key])])
        out.append((ens, rdms))
    np.testing.assert_allclose(out[0][0], out[1][0], rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(out[0][1], out[1][1], rtol=1e-8, atol=1e-10)


@pytest.mark.skipif(NDEV < 2, reason="needs multiple devices")
def test_itcf_sharded_matches_single_device(tmp_path):
    """ITCF (stable Feldbacher-Assaad accumulation over the stored B-matrix
    history) under a sharded walker axis matches the unsharded run.
    Reference collective: comm.Reduce in pauxy/estimators/itcf.py:524."""
    import h5py

    ham = make_hubbard(nup=3, ndown=3, U=4.0, nx=3, ny=3)
    trial = free_electron_trial(ham)
    qmc = QMCOpts(nwalkers=16, dt=0.05, nsteps=10, nblocks=3, nstblz=5,
                  npop_control=5, rng_seed=8)
    eopts = {
        "mixed": {"energy_eval_freq": 1},
        "itcf": {"tau_max": 0.25, "stable": True},
    }

    af1 = AFQMC(ham, trial, qmc, estimator_options=eopts,
                filename=str(tmp_path / "i1.h5"))
    rows1 = af1.run()

    af2 = AFQMC(ham, trial, qmc, estimator_options=eopts,
                filename=str(tmp_path / "i2.h5"))
    af2.state = pmesh.shard_walkers(af2.state, pmesh.walker_mesh())
    rows2 = af2.run()

    np.testing.assert_allclose(rows1[:, 1:10].real, rows2[:, 1:10].real,
                               rtol=1e-8, atol=1e-10)
    out = []
    for f in ("i1.h5", "i2.h5"):
        with h5py.File(str(tmp_path / f), "r") as fh5:
            grp = fh5["itcf/real_space_greens_function"]
            out.append(np.stack([grp[k][:] for k in sorted(grp)]))
    np.testing.assert_allclose(out[0], out[1], rtol=1e-7, atol=1e-9)


@pytest.mark.skipif(NDEV < 8, reason="needs 8 devices")
def test_clinalg_sharded():
    """Batched complex slogdet / solve / CholeskyQR2 on a walker-sharded
    batch agree with numpy (XLA partitions the batched factorizations)."""
    from pauxy_jax.ops import clinalg

    rng = np.random.default_rng(9)
    w, n, m = 16, 5, 12
    s = (rng.normal(size=(w, n, n))
         + 1j * rng.normal(size=(w, n, n))).astype(np.complex64)
    phi = (rng.normal(size=(w, m, n))
           + 1j * rng.normal(size=(w, m, n))).astype(np.complex64)
    mesh = pmesh.walker_mesh()
    sd = pmesh.shard_walkers(jnp.asarray(s), mesh)
    ld = np.asarray(clinalg.slogdet(sd))
    np.testing.assert_allclose(np.exp(ld), np.linalg.det(s), rtol=2e-3)
    y = jnp.asarray(phi).swapaxes(-1, -2)
    x = np.asarray(clinalg.solve(sd, y))
    np.testing.assert_allclose(s @ x, np.asarray(y), atol=2e-3)
    q, logr = clinalg.cholesky_qr2(pmesh.shard_walkers(
        jnp.asarray(phi), mesh))
    q = np.asarray(q)
    for i in range(w):
        np.testing.assert_allclose(q[i].conj().T @ q[i], np.eye(n),
                                   atol=1e-3)


@pytest.mark.skipif(NDEV < 8, reason="needs 8 devices")
def test_fast_block_sharded_matches_unsharded():
    """The fast Hubbard block on a walker-sharded state is trajectory-equal
    to the same block on the unsharded state."""
    from pauxy_jax.propagation import continuous
    from pauxy_jax.propagation.hubbard import make_hubbard_continuous
    from pauxy_jax.qmc import hubbard_fast as hf
    from pauxy_jax.utils.transfer import device_zeros

    ham = make_hubbard(nup=3, ndown=3, U=4.0, nx=3, ny=3)
    trial = free_electron_trial(ham)
    inner = make_hubbard_continuous(ham, trial, 0.01)
    prop = continuous.Continuous(inner=inner, dt=0.01)
    state = init_walkers(trial, 16, total_weight=16.0)
    eshift = device_zeros((), state.log_ovlp.dtype)
    kw = dict(nsteps=6, nstblz=3, npop_control=2, pop_method="comb",
              target_weight=16.0, energy_eval_freq=1)
    outs = []
    for st in (state, pmesh.shard_walkers(state, pmesh.walker_mesh())):
        s, a = hf.run_block_lanes(
            ham, trial, prop, st, jax.random.key(3), eshift,
            jnp.asarray(0, jnp.int32), **kw)
        outs.append((np.asarray(a), np.asarray(s.weight)))
    np.testing.assert_allclose(outs[0][0], outs[1][0], rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(outs[0][1], outs[1][1], rtol=1e-9)


@pytest.mark.skipif(NDEV < 2, reason="needs multiple devices")
def test_free_projection_sharded_matches_single_device(tmp_path):
    """Free projection under SPMD: complex FP weights (magnitude + phase
    tracked separately) must survive the sharded pop-control/estimator
    path trajectory-exactly."""
    ham = make_hubbard(nup=3, ndown=3, U=4.0, nx=3, ny=3,
                       ktwist=[0.01, -0.02])
    trial = free_electron_trial(ham)
    qmc = QMCOpts(nwalkers=16, dt=0.01, nsteps=5, nblocks=3, nstblz=5,
                  npop_control=5, rng_seed=11)

    def run(fn, shard):
        af = AFQMC(ham, trial, qmc,
                   propagator_options={"free_projection": True},
                   estimator_options={"mixed": {"energy_eval_freq": 1}},
                   filename=str(tmp_path / fn))
        if shard:
            af.state = pmesh.shard_walkers(af.state, pmesh.walker_mesh())
        return af.run()

    rows1 = run("fp1.h5", False)
    rows2 = run("fp2.h5", True)
    np.testing.assert_allclose(rows1[:, 1:10], rows2[:, 1:10],
                               rtol=1e-8, atol=1e-10)


@pytest.mark.skipif(NDEV < 2, reason="needs multiple devices")
def test_ghf_sharded_matches_single_device(tmp_path):
    """GHF (2M x ne) trial with the discrete site sweep under a sharded
    walker axis — the per-site GHF overlap-ratio path is the last trial
    family exercised by the SPMD matrix."""
    from pauxy_jax.models import ghf as ghf_mod

    ham = make_hubbard(nup=3, ndown=3, U=4.0, nx=3, ny=3)
    fe = free_electron_trial(ham)
    ghf = ghf_mod.ghf_trial_from_uhf(ham, np.asarray(fe.psia),
                                     np.asarray(fe.psib))
    qmc = QMCOpts(nwalkers=16, dt=0.05, nsteps=5, nblocks=3, nstblz=5,
                  npop_control=5, rng_seed=8)
    popts = {"hubbard_stratonovich": "discrete"}

    def run(fn, shard):
        af = AFQMC(ham, ghf, qmc, propagator_options=popts,
                   estimator_options={"mixed": {"energy_eval_freq": 1}},
                   filename=str(tmp_path / fn))
        if shard:
            af.state = pmesh.shard_walkers(af.state, pmesh.walker_mesh())
        return af.run()

    rows1 = run("g1.h5", False)
    rows2 = run("g2.h5", True)
    np.testing.assert_allclose(rows1[:, 1:10].real, rows2[:, 1:10].real,
                               rtol=1e-8, atol=1e-10)


@pytest.mark.skipif(NDEV < 2, reason="needs multiple devices")
def test_multi_coherent_sharded_matches_single_device(tmp_path):
    """Multi-coherent (translation-symmetrized) HH trial under a sharded
    walker axis: per-component phonon overlaps and the mixture-drift boson
    move must be SPMD-clean (reference walkers/multi_coherent.py)."""
    from pauxy_jax.models.hubbard_holstein import make_hubbard_holstein
    from pauxy_jax.models.multi_coherent import multi_coherent_trial

    ham = make_hubbard_holstein(nup=1, ndown=1, U=4.0, nx=3, g=0.4, w0=1.0,
                                xpbc=True)
    trial = multi_coherent_trial(ham)
    qmc = QMCOpts(nwalkers=16, dt=0.01, nsteps=6, nblocks=3, nstblz=3,
                  npop_control=3, rng_seed=4)

    def run(fn, shard):
        af = AFQMC(ham, trial, qmc,
                   estimator_options={"mixed": {"energy_eval_freq": 2}},
                   filename=str(tmp_path / fn))
        if shard:
            af.state = pmesh.shard_walkers(af.state, pmesh.walker_mesh())
        return af.run()

    rows1 = run("mc1.h5", False)
    rows2 = run("mc2.h5", True)
    np.testing.assert_allclose(rows1[:, 1:10].real, rows2[:, 1:10].real,
                               rtol=1e-8, atol=1e-10)
