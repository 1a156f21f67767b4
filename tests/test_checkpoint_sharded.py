"""Per-host sharded walker checkpoint (VERDICT r2 item 8).

Counterpart of the reference's collective parallel-HDF5 restart
(``pauxy/walkers/handler.py:148-157, 444-500``): one file per walker shard,
restored shard-by-shard onto the mesh devices.
"""

import jax
import numpy as np
import pytest

from pauxy_jax.models import make_hubbard, free_electron_trial
from pauxy_jax.parallel import mesh as pmesh
from pauxy_jax.qmc import AFQMC, QMCOpts
from pauxy_jax.utils.checkpoint import (load_walkers_sharded,
                                        save_walkers_sharded)
from pauxy_jax.walkers import init_walkers

NDEV = len(jax.devices())


def _random_state(nw=16, seed=3):
    ham = make_hubbard(nup=3, ndown=3, U=4.0, nx=3, ny=3,
                       ktwist=[0.01, -0.02])
    trial = free_electron_trial(ham)
    state = init_walkers(trial, nw)
    k = jax.random.key(seed)
    return ham, trial, state.replace(
        phia=state.phia + 0.1 * jax.random.normal(k, state.phia.shape),
        weight=jax.random.uniform(jax.random.fold_in(k, 1), (nw,),
                                  dtype=state.weight.dtype) + 0.5,
    )


@pytest.mark.skipif(NDEV < 2, reason="needs multiple devices")
def test_sharded_roundtrip_on_mesh(tmp_path):
    _, trial, state = _random_state()
    m = pmesh.walker_mesh()
    state = pmesh.shard_walkers(state, m)
    d = str(tmp_path / "ckpt")
    key = jax.random.key(99)
    save_walkers_sharded(state, d, key=key, step=70, eshift=-1.25)

    import glob
    import os

    assert len(glob.glob(os.path.join(d, "shard_*.h5"))) == NDEV

    template = pmesh.shard_walkers(init_walkers(trial, state.nwalkers), m)
    restored, info = load_walkers_sharded(template, d, mesh=m)
    assert info["step"] == 70
    assert info["eshift"] == -1.25
    assert info["rng_key"] is not None
    np.testing.assert_array_equal(
        jax.random.key_data(info["rng_key"]), jax.random.key_data(key)
    )
    for name in ("phia", "phib", "weight", "log_ovlp"):
        np.testing.assert_allclose(
            np.asarray(getattr(restored, name)),
            np.asarray(getattr(state, name)), atol=0, err_msg=name,
        )
    # Each per-walker leaf is actually sharded over the mesh.
    assert len(restored.phia.sharding.device_set) == NDEV


@pytest.mark.skipif(NDEV < 2, reason="needs multiple devices")
def test_sharded_save_dense_restore(tmp_path):
    """A sharded checkpoint restores on a single device too (elastic
    restart onto different topology)."""
    _, trial, state = _random_state()
    m = pmesh.walker_mesh()
    sstate = pmesh.shard_walkers(state, m)
    d = str(tmp_path / "ckpt2")
    save_walkers_sharded(sstate, d, step=5, eshift=0.5)
    template = init_walkers(trial, state.nwalkers)
    restored, info = load_walkers_sharded(template, d, mesh=None)
    np.testing.assert_allclose(np.asarray(restored.phia),
                               np.asarray(state.phia), atol=0)
    np.testing.assert_allclose(np.asarray(restored.weight),
                               np.asarray(state.weight), atol=0)


@pytest.mark.skipif(NDEV < 2, reason="needs multiple devices")
def test_driver_resumes_from_sharded_checkpoint(tmp_path):
    """Trajectory equivalence: run 2 blocks & checkpoint, restore into a
    fresh driver, run 1 more block -> identical to 3 uninterrupted blocks
    (the RNG-stream guarantee the dense checkpoint already has)."""
    ham = make_hubbard(nup=3, ndown=3, U=4.0, nx=3, ny=3,
                       ktwist=[0.01, -0.02])
    trial = free_electron_trial(ham)
    qmc3 = QMCOpts(nwalkers=16, dt=0.01, nsteps=5, nblocks=3, nstblz=5,
                   npop_control=2, rng_seed=11)
    af = AFQMC(ham, trial, qmc3,
               estimator_options={"mixed": {"energy_eval_freq": 1}},
               filename=str(tmp_path / "full.h5"))
    m = pmesh.walker_mesh()
    af.state = pmesh.shard_walkers(af.state, m)
    rows_full = af.run()

    import dataclasses

    qmc2 = dataclasses.replace(qmc3, nblocks=2)
    af1 = AFQMC(ham, trial, qmc2,
                estimator_options={"mixed": {"energy_eval_freq": 1}},
                filename=str(tmp_path / "part1.h5"))
    af1.state = pmesh.shard_walkers(af1.state, m)
    af1.run()
    d = str(tmp_path / "ckpt3")
    save_walkers_sharded(af1.state, d, key=af1.key, step=af1.step,
                         eshift=af1.eshift)

    qmc1 = dataclasses.replace(qmc3, nblocks=1)
    af2 = AFQMC(ham, trial, qmc1,
                estimator_options={"mixed": {"energy_eval_freq": 1}},
                filename=str(tmp_path / "part2.h5"))
    template = pmesh.shard_walkers(af2.state, m)
    af2.state, info = load_walkers_sharded(template, d, mesh=m)
    af2.step = info["step"]
    af2.eshift = info["eshift"]
    af2.key = info["rng_key"]
    rows_resumed = af2.run()

    np.testing.assert_allclose(rows_full[-1, 1:10].real,
                               rows_resumed[-1, 1:10].real,
                               rtol=1e-8, atol=1e-10)


@pytest.mark.skipif(len(jax.devices()) < 2, reason="needs multiple devices")
def test_incomplete_checkpoint_raises(tmp_path):
    """A field missing from SOME (not all) shard files is a truncated
    checkpoint: restore must fail loudly instead of silently mixing
    checkpointed walkers with template-fresh arrays."""
    import glob

    import h5py

    ham = make_hubbard(nup=2, ndown=2, U=4.0, nx=2, ny=2)
    trial = free_electron_trial(ham)
    m = pmesh.walker_mesh()
    state = pmesh.shard_walkers(init_walkers(trial, 16), m)
    d = str(tmp_path / "ckpt")
    save_walkers_sharded(state, d, step=1, eshift=0.0)
    victim = sorted(glob.glob(d + "/shard_*.h5"))[-1]
    with h5py.File(victim, "a") as fh5:
        del fh5["weight"]
    template = pmesh.shard_walkers(init_walkers(trial, 16), m)
    with pytest.raises(ValueError, match="incomplete"):
        load_walkers_sharded(template, d, mesh=m)
    with pytest.raises(ValueError, match="incomplete"):
        load_walkers_sharded(init_walkers(trial, 16), d, mesh=None)
