"""Cross-product option-matrix integration sweep.

Targeted tests cover each feature in isolation; this sweep drives the
JSON factory (`qmc/calc.get_driver`, the reference's `calc.py:42-55`
dispatch) through option COMBINATIONS users actually mix — population
control x estimator schedules x weight updates x trial families — and
asserts the run stays finite, weights stay alive, and the h5 output is
parseable. Interaction bugs (e.g. pair_branch moving BP histories,
free-projection phases through the reporter) live exactly in these
cross-products.
"""

import json
import os

import numpy as np
import pytest

from pauxy_jax.qmc.calc import get_driver


def _run(options, tmp_path, fname="est.h5"):
    options = json.loads(json.dumps(options))  # force plain-JSON types
    options.setdefault("estimates", {}).setdefault(
        "filename", str(tmp_path / fname)
    )
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        af = get_driver(options)
        rows = af.run()
    finally:
        os.chdir(cwd)
    rows = np.asarray(rows)
    assert np.isfinite(rows.real).all() and np.isfinite(rows.imag).all(), rows
    # Weight column (HEADER[2]) alive through the run.
    assert np.abs(rows[:, 2]).min() > 1e-8, rows[:, 2]
    from pauxy_jax.analysis.extraction import extract_mixed_estimates

    df = extract_mixed_estimates(str(tmp_path / fname))
    assert len(df) == len(rows)
    return rows, df


HUB = {"name": "Hubbard", "nx": 4, "ny": 1, "nup": 2, "ndown": 2, "U": 4.0}


@pytest.mark.driver
def test_discrete_pairbranch_bp_itcf(tmp_path):
    """Discrete Hirsch + pair_branch + BP(partial restore) + stable ITCF in
    ONE run: pop control must move the BP field history and the ITCF left
    wavefunctions with the parents (handler.py:340-412 + stack.py:34-127)."""
    opts = {
        "model": HUB,
        "qmc": {"timestep": 0.05, "num_steps": 4, "blocks": 3,
                "nwalkers": 12, "rng_seed": 3, "pop_control_freq": 2,
                "pop_control": "pair_branch", "stabilise_freq": 2},
        "trial": {"name": "free_electron"},
        "propagator": {"hubbard_stratonovich": "discrete"},
        "estimates": {
            "mixed": {"energy_eval_freq": 1},
            "back_propagation": {"tau_bp": 0.2, "restore_weights": "partial",
                                 "evaluate_energy": True},
            "itcf": {"tau_max": 0.2, "stable": True, "mode": "diagonal"},
        },
    }
    rows, _ = _run(opts, tmp_path)
    et = rows[:, 5].real
    # Sane energy scale for 4 sites at U=4 (free-electron trial E ~ 0).
    assert et.min() > -10 and et.max() < 5


@pytest.mark.driver
def test_free_projection_pairbranch(tmp_path):
    """Free projection (phased weights) + pair_branch: branching decisions
    are on |w| while the reporter keeps the phase (mixed.py:151-175)."""
    opts = {
        "model": HUB,
        "qmc": {"timestep": 0.01, "num_steps": 5, "blocks": 3,
                "nwalkers": 10, "rng_seed": 7, "pop_control_freq": 5,
                "pop_control": "pair_branch", "stabilise_freq": 5},
        "trial": {"name": "free_electron"},
        "propagator": {"free_projection": True},
        "estimates": {"mixed": {"energy_eval_freq": 1}},
    }
    rows, df = _run(opts, tmp_path)
    # FP energies are ratio estimates: E_num / E_denom stays finite and the
    # denominator carries a nontrivial phase in general.
    assert np.isfinite(df["ETotal"].to_numpy(complex)).all()


@pytest.mark.driver
def test_local_energy_update_with_one_rdm(tmp_path):
    """hybrid=false weight update + mixed one_rdm accumulation + comb
    (continuous.py:294-318 update_weight_local_energy path)."""
    opts = {
        "model": HUB,
        "qmc": {"timestep": 0.02, "num_steps": 5, "blocks": 3,
                "nwalkers": 10, "rng_seed": 5, "pop_control_freq": 5,
                "stabilise_freq": 5},
        "trial": {"name": "free_electron"},
        "propagator": {"hybrid": False},
        "estimates": {"mixed": {"energy_eval_freq": 1, "one_rdm": True}},
    }
    rows, _ = _run(opts, tmp_path)
    import h5py

    with h5py.File(str(tmp_path / "est.h5"), "r") as fh5:
        grp = fh5["basic/one_rdm"]
        g = np.stack([grp[k][:] for k in sorted(grp)])  # [blocks, 2, M, M]
    assert np.isfinite(g.real).all()
    # The pushed 1-RDM is weight-normalized: per-spin trace = electrons.
    tr = np.trace(g, axis1=-2, axis2=-1).real
    np.testing.assert_allclose(tr, [[2.0, 2.0]] * len(rows), atol=1e-8)


def _write_random_generic(tmp_path, nelec=(2, 2), nmo=6, seed=11):
    from pauxy_jax.utils.qmcpack import write_hamiltonian
    from pauxy_jax.utils.testing import generate_hamiltonian

    h1e, chol, enuc, _ = generate_hamiltonian(nmo, nelec, seed=seed)
    ham_file = str(tmp_path / "ham.h5")
    write_hamiltonian(h1e, chol, nelec, ecore=enuc, filename=ham_file)
    return ham_file


@pytest.mark.driver
def test_generic_bp_ekt_two_rdm(tmp_path):
    """Generic + BP with EKT and full 2-RDM together: the widest estimator
    tail (back_propagation.py:87-94 storage layout)."""
    nelec = (2, 2)
    ham_file = _write_random_generic(tmp_path, nelec)
    opts = {
        "model": {"name": "Generic", "integrals": ham_file,
                  "nup": nelec[0], "ndown": nelec[1]},
        "qmc": {"timestep": 0.01, "num_steps": 4, "blocks": 3,
                "nwalkers": 8, "rng_seed": 2, "pop_control_freq": 2,
                "stabilise_freq": 2},
        "trial": {"name": "hartree_fock"},
        "estimates": {
            "mixed": {"energy_eval_freq": 1},
            "back_propagation": {"tau_bp": 0.08, "evaluate_energy": True,
                                 "evaluate_ekt": True, "two_rdm": "full"},
        },
    }
    _run(opts, tmp_path)
    import h5py

    with h5py.File(str(tmp_path / "est.h5"), "r") as fh5:
        keys = list(fh5["back_propagated"].keys())
        assert any("1h" in k for k in keys), keys
        assert any("two_rdm" in k for k in keys), keys


@pytest.mark.driver
def test_phmsd_bp_clear_error(tmp_path):
    """BP with a multi-det trial fails AT SETUP with a clear message (the
    reference's BP is single-det only; its GHF branch is self-declared
    broken) rather than a shape error mid-run."""
    nelec = (2, 2)
    ham_file = _write_random_generic(tmp_path, nelec)
    opts = {
        "model": {"name": "Generic", "integrals": ham_file,
                  "nup": nelec[0], "ndown": nelec[1]},
        "qmc": {"timestep": 0.01, "num_steps": 4, "blocks": 2,
                "nwalkers": 8, "rng_seed": 2, "pop_control_freq": 2,
                "stabilise_freq": 2},
        "trial": {"name": "phmsd", "coefficients": [0.95, 0.05],
                  "occa": [[0, 1], [0, 2]], "occb": [[0, 1], [0, 1]]},
        "estimates": {
            "mixed": {"energy_eval_freq": 1},
            "back_propagation": {"tau_bp": 0.08},
        },
    }
    opts["estimates"]["filename"] = str(tmp_path / "est.h5")
    with pytest.raises(NotImplementedError, match="single-determinant"):
        get_driver(opts)
    # Same guard for ITCF.
    opts["estimates"] = {"filename": str(tmp_path / "est2.h5"),
                         "itcf": {"tau_max": 0.04}}
    with pytest.raises(NotImplementedError, match="single-determinant"):
        get_driver(opts)


@pytest.mark.driver
def test_ueg_pairbranch_itcf_kspace(tmp_path):
    """UEG + pair_branch + k-space ITCF (itcf.py:94,146-147 FFT output)."""
    opts = {
        "model": {"name": "UEG", "nup": 2, "ndown": 2, "rs": 1.0,
                  "ecut": 0.5},
        "qmc": {"timestep": 0.01, "num_steps": 4, "blocks": 2,
                "nwalkers": 8, "rng_seed": 4, "pop_control_freq": 2,
                "pop_control": "pair_branch", "stabilise_freq": 2},
        "trial": {"name": "hartree_fock"},
        "estimates": {
            "mixed": {"energy_eval_freq": 1},
            "itcf": {"tau_max": 0.04, "stable": True, "mode": "diagonal",
                     "kspace": True},
        },
    }
    _run(opts, tmp_path)


@pytest.mark.driver
def test_thermal_continuous_pairbranch_avggf(tmp_path):
    """Thermal Hubbard continuous + pair_branch per slice + average_gf."""
    opts = {
        "model": HUB,
        "qmc": {"timestep": 0.05, "blocks": 3, "nwalkers": 8,
                "rng_seed": 6, "beta": 0.5, "pop_control_freq": 2,
                "pop_control": "pair_branch"},
        "trial": {"name": "one_body", "mu": 0.2},
        "estimates": {"mixed": {"average_gf": True}},
    }
    opts["estimates"]["filename"] = str(tmp_path / "est.h5")
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        af = get_driver(opts)
        rows = np.asarray(af.run())
    finally:
        os.chdir(cwd)
    assert np.isfinite(rows.real).all()
    assert np.abs(rows[:, 2]).min() > 1e-8


@pytest.mark.driver
def test_hh_symmetric_trotter_pairbranch(tmp_path):
    """Hubbard-Holstein discrete (HirschDMC) + symmetric Trotter + pair
    branch: phonon arrays must move with parents through pop control."""
    model = {"name": "HubbardHolstein", "nx": 4, "ny": 1, "nup": 2,
             "ndown": 2, "U": 1.0, "w0": 1.0, "lambda": 0.25}
    opts = {
        "model": model,
        "qmc": {"timestep": 0.02, "num_steps": 5, "blocks": 3,
                "nwalkers": 10, "rng_seed": 9, "pop_control_freq": 5,
                "pop_control": "pair_branch", "stabilise_freq": 5},
        "trial": {"name": "coherent_state"},
        "propagator": {"hubbard_stratonovich": "discrete",
                       "symmetric_trotter": True},
        "estimates": {"mixed": {"energy_eval_freq": 1}},
    }
    _run(opts, tmp_path)

    # An electron-only trial has no phonon shift: clear setup error (the
    # reference crashes with AttributeError, hubbard_holstein.py:134).
    bad = json.loads(json.dumps(opts))
    bad["trial"] = {"name": "free_electron"}
    bad["estimates"]["filename"] = str(tmp_path / "bad.h5")
    with pytest.raises(ValueError, match="phonon-aware"):
        get_driver(bad)


@pytest.mark.driver
def test_uhf_trial_direct_update_spin_proj(tmp_path):
    """UHF trial + whole-lattice 'direct' update + spin_proj walker init +
    per-step pop control (the CPMC standard for the direct update)."""
    opts = {
        "model": {"name": "Hubbard", "nx": 4, "ny": 1, "nup": 2, "ndown": 2,
                  "U": 4.0},
        "qmc": {"timestep": 0.05, "num_steps": 4, "blocks": 3,
                "nwalkers": 12, "rng_seed": 1, "pop_control_freq": 1,
                "stabilise_freq": 2},
        "trial": {"name": "UHF", "spin_proj": True, "ninitial": 2,
                  "nconv": 200},
        "propagator": {"hubbard_stratonovich": "discrete",
                       "two_body_update": "direct"},
        "estimates": {"mixed": {"energy_eval_freq": 1}},
    }
    _run(opts, tmp_path)


@pytest.mark.driver
def test_multi_coherent_one_rdm(tmp_path):
    """Multi-coherent (symmetrized coherent-state) trial + mixed one_rdm:
    the pushed RDM is the component-weighted mixture G (the reference
    pushes w.G where the walker G IS that mixture, multi_coherent.py:360)
    so the per-spin trace equals the electron count exactly."""
    model = {"name": "HubbardHolstein", "nx": 4, "ny": 1, "nup": 2,
             "ndown": 2, "U": 1.0, "w0": 1.0, "lambda": 0.25}
    opts = {
        "model": model,
        "qmc": {"timestep": 0.02, "num_steps": 4, "blocks": 3,
                "nwalkers": 8, "rng_seed": 12, "pop_control_freq": 4,
                "stabilise_freq": 4},
        "trial": {"name": "coherent_state", "symmetrize": True},
        "estimates": {"mixed": {"energy_eval_freq": 1, "one_rdm": True}},
    }
    rows, _ = _run(opts, tmp_path)
    import h5py

    with h5py.File(str(tmp_path / "est.h5"), "r") as fh5:
        grp = fh5["basic/one_rdm"]
        g = np.stack([grp[k][:] for k in sorted(grp)])  # [blocks, 2, M, M]
    assert np.isfinite(g).all()
    tr = np.trace(g, axis1=-2, axis2=-1)
    np.testing.assert_allclose(tr, [[2.0, 2.0]] * len(rows), atol=1e-7)


@pytest.mark.driver
def test_generic_stochastic_ri_prop_and_energy(tmp_path):
    """Stochastic-RI in BOTH the kinetic propagator (operations.py:54-90)
    and the local energy (generic.py:293-397) simultaneously."""
    from pauxy_jax.utils.qmcpack import write_hamiltonian
    from pauxy_jax.utils.testing import generate_hamiltonian

    nmo, nelec = 6, (2, 2)
    h1e, chol, enuc, _ = generate_hamiltonian(nmo, nelec, seed=13)
    ham_file = str(tmp_path / "ham.h5")
    write_hamiltonian(h1e, chol, nelec, ecore=enuc, filename=ham_file)
    opts = {
        "model": {"name": "Generic", "integrals": ham_file,
                  "nup": nelec[0], "ndown": nelec[1],
                  "stochastic_ri": True, "nsamples": 16},
        "qmc": {"timestep": 0.005, "num_steps": 4, "blocks": 2,
                "nwalkers": 8, "rng_seed": 8, "pop_control_freq": 2,
                "stabilise_freq": 2},
        "trial": {"name": "hartree_fock"},
        "propagator": {"stochastic_ri": True, "nsamples": 16},
        "estimates": {"mixed": {"energy_eval_freq": 1}},
    }
    _run(opts, tmp_path)
